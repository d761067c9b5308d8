"""Batched P3P (Grunert) minimal absolute-pose solver.

The reference localises cameras with OpenGV's EPnP inside a sequential
RANSAC (include/visnav/map_utils.h:268-278).  The batched re-design wants a
MINIMAL solver so hypotheses survive high outlier rates (P(clean sample)
= (1-e)^3 for P3P vs (1-e)^6 for the round-1 6-point DLT), solved for
hundreds of samples at once under vmap.

Grunert's classic reduction: with s_i the camera-frame distances to the
three world points, substituting s2 = u*s1, s3 = v*s1 into the three
law-of-cosines equations eliminates s1 and u, leaving a QUARTIC in v.
The quartic coefficients are assembled numerically by 1-D convolutions
of the small sub-polynomials (no hand-expanded algebra), its real roots
come from Ferrari's closed form (resolvent cubic via Cardano — exact,
branch-free with jnp.where, no ``eig``; the bisection-grid finder used
for the 5-point degree-10 polynomial misses P3P's frequently-clustered
quartic roots), and each root yields camera-frame points whose rigid
alignment to the world points (3-point Procrustes) gives T_c_w.

Reference for the derivation: Haralick et al., "Review and Analysis of
Solutions of the Three Point Perspective Pose Estimation Problem" (the
public classic; text derivation only, no code consulted).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

def _cubic_one_real_root(b, c, d):
    """One real root of x^3 + b x^2 + c x + d (monic), branch-free.

    Uses Cardano for the one-real-root case and the trigonometric form
    when all three roots are real (picks the largest).
    """
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    u = jnp.cbrt(-q / 2.0 + sq)
    v = jnp.cbrt(-q / 2.0 - sq)
    root_card = u + v
    # three-real-root (casus irreducibilis): 2 sqrt(-p/3) cos(phi/3)
    pm = jnp.sqrt(jnp.maximum(-p / 3.0, 1e-300))
    cosphi = jnp.clip(3.0 * q / (2.0 * p * pm + 1e-300), -1.0, 1.0)
    root_trig = 2.0 * pm * jnp.cos(jnp.arccos(cosphi) / 3.0)
    return jnp.where(disc > 0.0, root_card, root_trig) - b / 3.0


def quartic_real_roots(coeffs):
    """Real roots of a quartic (coeffs (5,) DESCENDING), Ferrari closed
    form — machine precision, no eig, no root-cluster grid failures.

    Returns (roots (4,), valid (4,)).
    """
    dtype = coeffs.dtype
    a = coeffs / (coeffs[0] + jnp.where(coeffs[0] == 0.0,
                                        jnp.finfo(dtype).tiny, 0.0))
    a3, a2, a1, a0 = a[1], a[2], a[3], a[4]
    # depressed quartic y^4 + p y^2 + q y + r  with x = y - a3/4
    p = a2 - 3.0 * a3 * a3 / 8.0
    q = a1 - a3 * a2 / 2.0 + a3 ** 3 / 8.0
    r = (a0 - a3 * a1 / 4.0 + a3 * a3 * a2 / 16.0
         - 3.0 * a3 ** 4 / 256.0)
    # resolvent cubic 8m^3 + 8p m^2 + (2p^2 - 8r) m - q^2 = 0 (monic form)
    m = _cubic_one_real_root(p, (2.0 * p * p - 8.0 * r) / 8.0,
                             -q * q / 8.0)
    m = jnp.maximum(m, 0.0)
    s = jnp.sqrt(jnp.maximum(2.0 * m, 0.0))
    safe = s > 1e-14
    q_over = jnp.where(safe, q / jnp.where(safe, 2.0 * s, 1.0), 0.0)
    # y^2 - s y + (p/2 + m + q/(2s)) = 0   and   y^2 + s y + (p/2 + m - ..)
    c1 = p / 2.0 + m + q_over
    c2 = p / 2.0 + m - q_over
    # biquadratic fallback when q ~ 0 and m ~ 0: y^2 = (-p +- sqrt(p^2-4r))/2
    dbi = p * p - 4.0 * r
    y2a = (-p + jnp.sqrt(jnp.maximum(dbi, 0.0))) / 2.0
    y2b = (-p - jnp.sqrt(jnp.maximum(dbi, 0.0))) / 2.0

    def quad(b_, c_):
        d_ = b_ * b_ - 4.0 * c_
        ok = d_ >= 0.0
        sd = jnp.sqrt(jnp.maximum(d_, 0.0))
        return ((-b_ + sd) / 2.0, ok), ((-b_ - sd) / 2.0, ok)

    (ra, va), (rb, vb) = quad(-s, c1)
    (rc, vc), (rd, vd) = quad(s, c2)
    roots_f = jnp.stack([ra, rb, rc, rd])
    valid_f = jnp.stack([va, vb, vc, vd])
    # biquadratic roots (q ~ 0 degenerate)
    roots_b = jnp.stack([jnp.sqrt(jnp.maximum(y2a, 0.0)),
                         -jnp.sqrt(jnp.maximum(y2a, 0.0)),
                         jnp.sqrt(jnp.maximum(y2b, 0.0)),
                         -jnp.sqrt(jnp.maximum(y2b, 0.0))])
    valid_b = jnp.stack([(dbi >= 0.0) & (y2a >= 0.0)] * 2
                        + [(dbi >= 0.0) & (y2b >= 0.0)] * 2)
    use_bi = (~safe) & (jnp.abs(q) < 1e-12)
    roots = jnp.where(use_bi, roots_b, roots_f) - a3 / 4.0
    valid = jnp.where(use_bi, valid_b, valid_f)
    # one Newton polish step (cheap; tightens f32)
    powers = roots[:, None] ** jnp.arange(4, -1, -1, dtype=dtype)[None, :]
    dpow = (jnp.arange(4, 0, -1, dtype=dtype)[None, :]
            * roots[:, None] ** jnp.arange(3, -1, -1, dtype=dtype)[None, :])
    f_val = powers @ a
    f_der = dpow @ a[:4]
    roots = roots - f_val / jnp.where(jnp.abs(f_der) > 1e-30, f_der, 1e30)
    return roots, valid


def _triad(P, tiny):
    """Right-handed orthonormal frame (columns) spanned by a 3-point set:
    x along P1-P0, z along the triangle normal, y completing.  Returns
    (B (3, 3), ok) — ok False when the points are (near-)collinear."""
    d1 = P[1] - P[0]
    d2 = P[2] - P[0]
    n1 = jnp.linalg.norm(d1)
    x = d1 / jnp.maximum(n1, tiny)
    zraw = jnp.cross(d1, d2)
    nz = jnp.linalg.norm(zraw)
    z = zraw / jnp.maximum(nz, tiny)
    y = jnp.cross(z, x)
    ok = nz > 1e-9 * n1 * jnp.linalg.norm(d2)
    return jnp.stack([x, y, z], axis=1), ok


def _rigid_3pt(Pw, Pc, tiny):
    """Rigid T_c_w aligning 3 world points Pw (3, 3) onto camera points
    Pc (3, 3): returns (R, t, ok) with Pc ~= R Pw + t.

    The P3P distance roots make the two triangles congruent up to
    roundoff, so the alignment is the exact frame-to-frame rotation
    between the two triangle triads — no SVD.  (The earlier 3x3-SVD
    Procrustes was 2048 batched Jacobi SVDs per localize call and ~70%
    of the kernel's device time, scripts/profile_localize.py.)"""
    Bw, okw = _triad(Pw, tiny)
    Bc, okc = _triad(Pc, tiny)
    R = Bc @ Bw.T
    cw = Pw.mean(0)
    cc = Pc.mean(0)
    t = cc - R @ cw
    return R, t, okw & okc


def p3p_candidates(f: jax.Array, Pw: jax.Array):
    """Absolute-pose candidates from 3 bearing<->point correspondences.

    Args:
      f:  (3, 3) unit bearing vectors in the camera frame.
      Pw: (3, 3) world points.

    Returns:
      Rs: (4, 3, 3), ts: (4, 3) candidate T_c_w poses (x_cam = R x_w + t);
      valid: (4,) bool (real-root slots found and geometry non-degenerate).
    """
    dtype = f.dtype
    tiny = jnp.finfo(dtype).tiny

    ca = jnp.dot(f[1], f[2])   # cos(alpha): angle opposite side a = |P2P3|
    cb = jnp.dot(f[0], f[2])   # cos(beta):  opposite b = |P1P3|
    cg = jnp.dot(f[0], f[1])   # cos(gamma): opposite c = |P1P2|
    a2 = jnp.sum((Pw[1] - Pw[2]) ** 2)
    b2 = jnp.sum((Pw[0] - Pw[2]) ** 2)
    c2 = jnp.sum((Pw[0] - Pw[1]) ** 2)
    b2 = jnp.maximum(b2, tiny)
    m = (a2 - c2) / b2
    n = c2 / b2

    # u = P(v) / Q(v) with
    #   P(v) = (m-1) v^2 - 2 m cb v + (m+1),  Q(v) = 2 (cg - v ca)
    # substituted into  u^2 - 2 u cg + 1 - n (1 + v^2 - 2 v cb) = 0
    # multiplied by Q^2:
    #   P^2 - 2 cg P Q + W Q^2 = 0,  W(v) = -n v^2 + 2 n cb v + (1 - n)
    P = jnp.stack([m - 1.0, -2.0 * m * cb, m + 1.0])          # desc v^2..1
    Q = jnp.stack([-2.0 * ca, 2.0 * cg])                      # desc v..1
    W = jnp.stack([-n, 2.0 * n * cb, 1.0 - n])

    # poly_mul, not jnp.convolve (see features/nister.py poly_mul)
    from photometric_bundle_adjustment_tpu.features.nister import poly_mul

    quart = (poly_mul(P, P)
             - 2.0 * cg * jnp.pad(poly_mul(P, Q), (1, 0))
             + poly_mul(W, poly_mul(Q, Q)))                   # (5,) desc

    v, vvalid = quartic_real_roots(quart)

    def pose_of_root(vr):
        u = (((m - 1.0) * vr - 2.0 * m * cb) * vr + (m + 1.0)) / (
            2.0 * (cg - vr * ca) + jnp.where(cg == vr * ca, tiny, 0.0)
        )
        s1sq = b2 / jnp.maximum(1.0 + vr * vr - 2.0 * vr * cb, tiny)
        s1 = jnp.sqrt(jnp.maximum(s1sq, 0.0))
        s = jnp.stack([s1, u * s1, vr * s1])
        Pc = s[:, None] * f                      # camera-frame points
        R, t, ok_geom = _rigid_3pt(Pw, Pc, tiny)
        ok = (s > 0.0).all() & ok_geom           # points in front
        return R, t, ok

    Rs, ts, oks = jax.vmap(pose_of_root)(v)
    finite = (jnp.isfinite(Rs).all(axis=(1, 2)) & jnp.isfinite(ts).all(1))
    return Rs, ts, vvalid & oks & finite
