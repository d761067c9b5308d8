"""Batched Nister 5-point minimal essential-matrix solver.

Replaces the reference's OpenGV ``NISTER`` sequential RANSAC sampler
(include/visnav/matching_utils.h:111-124) with a formulation where EVERY
step is a fixed-shape batched tensor operation, so hundreds of minimal
samples are solved simultaneously under vmap/jit (and the polynomial
root-finding needs no ``eig``, which XLA does not provide on every
backend):

1. nullspace: SVD of the 5x9 epipolar constraint matrix -> basis
   E = x*E1 + y*E2 + z*E3 + E4  (w normalised to 1).
2. the 10 cubic constraints (det(E) = 0 and the trace condition
   2*E*E^T*E - tr(E*E^T)*E = 0) are expanded over fixed monomial bases by
   two constant sparse product tensors (linear x linear -> quadratic,
   quadratic x linear -> cubic); no symbolic algebra at runtime.
3. Gauss-Jordan elimination of the leading 10 monomials (one 10x10
   solve), then Nister's three compatibility rows give a 3x3 matrix B(z)
   with polynomial entries whose determinant is the degree-10 polynomial.
4. real roots of the degree-10 polynomial: the projective substitution
   z = tan(theta) turns the real line into a bounded interval; the
   polynomial is evaluated HOMOGENEOUSLY (sum a_k sin^k cos^(10-k), no
   overflow), sign changes on a fixed theta-grid are refined by a fixed
   number of bisection steps.  Fixed shapes: up to 10 root slots with a
   validity mask.
5. x, y for each root from the 3x2 least-squares system B(z)[x y 1]^T=0.

Everything is f64-recommended (the reduced system is ill-conditioned in
f32; tests pin f64 on CPU), but the module is dtype-generic.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# monomial bases and constant product tensors
# ---------------------------------------------------------------------------

_LIN = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # [x, y, z, 1]
_QUAD = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (1, 0, 0),
    (0, 2, 0), (0, 1, 1), (0, 1, 0),
    (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
# cubic basis in the Gauss-Jordan order: leading block L then trailing v
# L = [x^3, y^3, x^2 y, x y^2, x^2 z, x^2, y^2 z, y^2, x y z, x y]
# v = [x z^2, x z, x, y z^2, y z, y, z^3, z^2, z, 1]
_CUBIC = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_QIDX = {m: i for i, m in enumerate(_QUAD)}
_CIDX = {m: i for i, m in enumerate(_CUBIC)}


def _product_tensors():
    M_llq = np.zeros((4, 4, 10))
    for i, a in enumerate(_LIN):
        for j, b in enumerate(_LIN):
            m = tuple(x + y for x, y in zip(a, b))
            M_llq[i, j, _QIDX[m]] = 1.0
    M_qlc = np.zeros((10, 4, 20))
    for i, a in enumerate(_QUAD):
        for j, b in enumerate(_LIN):
            m = tuple(x + y for x, y in zip(a, b))
            M_qlc[i, j, _CIDX[m]] = 1.0
    return M_llq, M_qlc


_M_LLQ, _M_QLC = _product_tensors()


def _ll(a, b, dtype):
    """linear (.., 4) x linear (.., 4) -> quadratic (.., 10)."""
    return jnp.einsum("...i,...j,ijk->...k", a, b,
                      jnp.asarray(_M_LLQ, dtype))


def _ql(q, l, dtype):
    """quadratic (.., 10) x linear (.., 4) -> cubic (.., 20)."""
    return jnp.einsum("...i,...j,ijk->...k", q, l,
                      jnp.asarray(_M_QLC, dtype))


# ---------------------------------------------------------------------------
# constraint matrix
# ---------------------------------------------------------------------------


def _constraint_matrix(Ebasis):
    """Ebasis: (4, 3, 3) nullspace basis [E1, E2, E3, E4].

    Returns the (10, 20) coefficient matrix of the 10 cubic constraints
    over the ``_CUBIC`` monomial basis.
    """
    dtype = Ebasis.dtype
    # E entry (i, j) as linear polynomial coeff vector over [x, y, z, 1]
    Elin = jnp.transpose(Ebasis, (1, 2, 0))  # (3, 3, 4)

    # P = E E^T (quadratic), P_ij = sum_k E_ik E_jk
    P = jnp.einsum(
        "ika,jkb,abq->ijq", Elin, Elin, jnp.asarray(_M_LLQ, dtype)
    )  # (3, 3, 10)
    trace = P[0, 0] + P[1, 1] + P[2, 2]  # (10,)

    # C = P E (cubic): C_il = sum_j P_ij E_jl
    C = jnp.einsum(
        "ijq,jla,qac->ilc", P, Elin, jnp.asarray(_M_QLC, dtype)
    )  # (3, 3, 20)
    trE = _ql(jnp.broadcast_to(trace, (3, 3, 10)), Elin, dtype)
    trace_rows = (2.0 * C - trE).reshape(9, 20)

    # det(E) cubic: expansion along the first row
    def minor(r0, r1, c0, c1):
        return (_ll(Elin[r0, c0], Elin[r1, c1], dtype)
                - _ll(Elin[r0, c1], Elin[r1, c0], dtype))

    det = (_ql(minor(1, 2, 1, 2), Elin[0, 0], dtype)
           - _ql(minor(1, 2, 0, 2), Elin[0, 1], dtype)
           + _ql(minor(1, 2, 0, 1), Elin[0, 2], dtype))

    return jnp.concatenate([det[None, :], trace_rows], axis=0)  # (10, 20)


# ---------------------------------------------------------------------------
# degree-10 polynomial and roots
# ---------------------------------------------------------------------------


def poly_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Product of two 1-D polynomial coefficient vectors (tiny static
    lengths), as an unrolled pad-and-add.

    ``jnp.convolve`` lowers to a reversed-window convolution, which is a
    poor fit for a handful of coefficients; for the
    <= 8-coefficient polynomials of the minimal solvers this formulation
    fuses identically and avoids windowed ops entirely.
    """
    la, lb = a.shape[0], b.shape[0]
    out = jnp.zeros(la + lb - 1, jnp.result_type(a, b))
    for i in range(la):
        out = out + jnp.pad(a[i] * b, (i, la - 1 - i))
    return out


def _gauss_jordan_inv(A: jax.Array) -> jax.Array:
    """Inverse of a small (n, n) matrix by PIVOT-FREE Gauss-Jordan
    elimination, unrolled over the n static steps.

    Each step divides by the (tiny-clamped) diagonal entry and applies
    one rank-1 update — no argmax, no row gathers.  The pivot SEARCH
    dominated the pivoted version's device time; forgoing it costs
    bounded accuracy that the caller's iterative-refinement steps
    recover (measured over 300 clean
    5-point systems: max relative solve residual 3.0e-11 vs 1.8e-11 in
    f64, 1.5% vs 0.8% worst-case in f32 — and RANSAC's algebraic
    prescreen + scoring discards the rare ill-conditioned sample's
    candidates anyway).
    """
    n = A.shape[0]
    dtype = A.dtype
    tiny = jnp.finfo(dtype).tiny
    aug = jnp.concatenate([A, jnp.eye(n, dtype=dtype)], axis=1)  # (n, 2n)
    rows = jnp.arange(n)
    for k in range(n):
        piv = aug[k, k]
        piv = jnp.where(jnp.abs(piv) > tiny, piv,
                        jnp.where(piv < 0, -tiny, tiny))
        piv_row = aug[k] / piv
        factors = jnp.where(rows == k, 0.0, aug[:, k])
        aug = aug - factors[:, None] * piv_row[None, :]
        aug = jnp.where((rows == k)[:, None], piv_row[None, :], aug)
    return aug[:, n:]


def _action_polynomials(A):
    """A: (10, 20) constraint matrix.  Returns the 3x3 polynomial matrix
    B(z) as (Bxy (3, 2, 4), Bc (3, 5)) — column coefficients in DESCENDING
    powers — and the degree-10 determinant coefficients (11,) descending.
    """
    A1, A2 = A[:, :10], A[:, 10:]
    # invert once via Gauss-Jordan, then apply by matmul: the pivoted LU
    # factor + four triangular solves cost ~50 sequential masked steps at
    # 10x10 (scripts/profile_nister.py); the GJ inverse is 10 steps of
    # batched rank-1 updates and the solves become batched matmuls.
    A1inv = _gauss_jordan_inv(A1)
    X = A1inv @ A2  # (10, 10)
    # two iterative-refinement steps: the elimination is the f32 accuracy
    # bottleneck, and the second step compensates the pivot-free GJ's
    # extra rounding; each costs two 10x10 matmuls
    X = X + A1inv @ (A2 - A1 @ X)
    X = X + A1inv @ (A2 - A1 @ X)

    # leading-monomial indices in L: x^2=5, x^2 z=4; y^2=7, y^2 z=6;
    # x y=9, x y z=8.  Row for pair (m, mz): z*expr(m) - expr(mz) = 0.
    def row(m, mz):
        c, d = -X[m], -X[mz]
        bx = jnp.stack([c[0], c[1] - d[0], c[2] - d[1], -d[2]])
        by = jnp.stack([c[3], c[4] - d[3], c[5] - d[4], -d[5]])
        bc = jnp.stack(
            [c[6], c[7] - d[6], c[8] - d[7], c[9] - d[8], -d[9]]
        )
        return bx, by, bc

    rows = [row(5, 4), row(7, 6), row(9, 8)]
    Bx = jnp.stack([r[0] for r in rows])  # (3, 4)
    By = jnp.stack([r[1] for r in rows])  # (3, 4)
    Bc = jnp.stack([r[2] for r in rows])  # (3, 5)

    # det expansion along the x-column
    def minor(r1, r2):
        return poly_mul(By[r1], Bc[r2]) - poly_mul(By[r2], Bc[r1])  # (8,)

    det = (poly_mul(Bx[0], minor(1, 2))
           - poly_mul(Bx[1], minor(0, 2))
           + poly_mul(Bx[2], minor(0, 1)))  # (11,) descending z^10 .. z^0

    return jnp.stack([Bx, By], axis=1), Bc, det


def _powers(x, D):
    """(..., D+1) with x^0 .. x^D along the last axis — explicit repeated
    multiplication (float ``**`` with an array exponent lowers to the
    transcendental pow on the VPU; for D <= 10 this is just D fused
    multiplies)."""
    ps = [jnp.ones_like(x)]
    for _ in range(D):
        ps.append(ps[-1] * x)
    return jnp.stack(ps, axis=-1)


def _eval_homog(coeffs, s, c):
    """Evaluate sum coeffs[i] z^(D-i) homogeneously at z = s/c:
    returns sum coeffs[i] s^(D-i) c^i  (= value * c^D, same sign for c>0).
    coeffs: (..., D+1) descending; s, c: (...,).
    """
    D = coeffs.shape[-1] - 1
    # stack s-powers DESCENDING at trace time rather than reversing at
    # runtime: a [..., ::-1] slice would emit stablehlo.reverse (same
    # class of lowering as poly_mul's note)
    ps = [jnp.ones_like(s)]
    for _ in range(D):
        ps.append(ps[-1] * s)
    sp = jnp.stack(ps[::-1], axis=-1)  # s^D .. s^0 (Python-list reverse)
    cp = _powers(c, D)              # c^0 .. c^D
    return jnp.sum(coeffs * sp * cp, axis=-1)


def _eval_homog_deriv(coeffs, s, c):
    """d/dtheta of the homogeneous evaluation at (s, c) = (sin, cos)theta:
    d/dtheta [s^(D-i) c^i] = (D-i) s^(D-i-1) c^(i+1) - i s^(D-i+1) c^(i-1).
    """
    D = coeffs.shape[-1] - 1
    ps = [jnp.ones_like(s)]
    for _ in range(D + 1):
        ps.append(ps[-1] * s)
    cs = [jnp.ones_like(c)]
    for _ in range(D + 1):
        cs.append(cs[-1] * c)
    terms = []
    for i in range(D + 1):
        t1 = (D - i) * ps[D - i - 1] * cs[i + 1] if i < D else 0.0
        t2 = i * ps[D - i + 1] * cs[i - 1] if i > 0 else 0.0
        terms.append(t1 - t2)
    dv = jnp.stack(terms, axis=-1)
    return jnp.sum(coeffs * dv, axis=-1)


def real_roots(coeffs, max_roots, n_grid=256, n_bisect=14, n_newton=3):
    """Up to ``max_roots`` real roots of a polynomial (coeffs DESCENDING).

    Returns (roots (max_roots,), valid (max_roots,)).  Projective
    theta-grid (z = tan theta) + homogeneous evaluation + fixed bisection
    + Newton polish in theta; fully fixed-shape, no ``eig`` — usable
    inside vmap/jit on any backend.  Shared by the 5-point (degree 10) and P3P
    (degree 4) solvers.  14 bisections narrow the ~1.2e-2-wide grid
    bracket to ~7e-7 and the 3 safeguarded Newton steps square the error
    past f64 machine precision — equivalent to the original 48 pure
    bisections on a 512-point grid at a third of the sequential depth
    and half the grid-evaluation width (the stage is latency-bound).
    Tight root
    PAIRS inside one grid cell cancel their sign change and are lost at
    any finite grid; the 62%-outlier A/B acceptance test and the f64
    E-recovery test bound that risk empirically at 256 points.
    """
    dtype = coeffs.dtype
    D = coeffs.shape[-1] - 1
    scale = jnp.max(jnp.abs(coeffs))
    det = coeffs / jnp.maximum(scale, jnp.finfo(dtype).tiny)

    theta = jnp.linspace(-np.pi / 2, np.pi / 2, n_grid,
                         dtype=dtype)[1:-1]
    # the GRID evaluation is one matmul against a static power table
    # P[i, g] = s_g^(D-i) c_g^i (the grid is static): under the RANSAC
    # vmap this turns 4096 x 254 elementwise homogeneous evaluations
    # into a single (B, D+1) x (D+1, G) matrix product.  HIGHEST
    # precision: sign changes near zero pick the root brackets.
    th_np = np.linspace(-np.pi / 2, np.pi / 2, n_grid)[1:-1]
    P_np = np.stack(
        [np.sin(th_np) ** (D - i) * np.cos(th_np) ** i
         for i in range(D + 1)], axis=0,
    )
    q = jnp.dot(det, jnp.asarray(P_np, dtype),
                precision=jax.lax.Precision.HIGHEST)
    change = (q[:-1] * q[1:]) < 0.0  # (n_grid - 3,)
    n = change.shape[0]
    score = change.astype(dtype) * (2.0 * n - jnp.arange(n, dtype=dtype))
    top, idx = jax.lax.top_k(score, max_roots)
    valid = top > 0.0
    lo = theta[idx]
    hi = theta[idx + 1]
    qlo = q[idx]

    def body(_, state):
        lo, hi, qlo = state
        mid = 0.5 * (lo + hi)
        qm = _eval_homog(det, jnp.sin(mid), jnp.cos(mid))
        left = (qlo * qm) > 0.0
        return (jnp.where(left, mid, lo), jnp.where(left, hi, mid),
                jnp.where(left, qm, qlo))

    lo, hi, _ = jax.lax.fori_loop(0, n_bisect, body, (lo, hi, qlo))
    th = 0.5 * (lo + hi)

    def newton(_, th):
        s, c = jnp.sin(th), jnp.cos(th)
        f = _eval_homog(det, s, c)
        fp = _eval_homog_deriv(det, s, c)
        step = f / jnp.where(jnp.abs(fp) > jnp.finfo(dtype).tiny, fp,
                             jnp.finfo(dtype).max)
        # keep the iterate inside the bisection bracket (safeguarded)
        return jnp.clip(th - step, lo, hi)

    th = jax.lax.fori_loop(0, n_newton, newton, th)
    roots = jnp.tan(th)
    return roots, valid


# ---------------------------------------------------------------------------
# public solver
# ---------------------------------------------------------------------------


def _null4_of_5x9(Q: jax.Array) -> jax.Array:
    """Orthonormal basis (4, 9) of null(Q) for full-rank Q (5, 9), by 5
    unrolled Householder reflectors on Q^T.

    With Q^T = H1 H2 .. H5 [R; 0], the last 4 columns of H1 .. H5 (i.e.
    the reflectors applied to e_5..e_8) are orthonormal and annihilated
    by Q.  Each reflector is one masked norm + rank-1 update — fully
    batched under vmap, no library QR kernels.
    """
    dtype = Q.dtype
    tiny = jnp.finfo(dtype).tiny
    A = Q.T  # (9, 5)
    n = A.shape[0]
    rows = jnp.arange(n)
    vs = []
    for k in range(5):
        x = jnp.where(rows >= k, A[:, k], 0.0)
        nx = jnp.linalg.norm(x)
        # alpha = -sign(x_k) * ||x|| avoids cancellation
        alpha = -jnp.where(x[k] >= 0, nx, -nx)
        v = x - alpha * (rows == k).astype(dtype)
        v = v / jnp.maximum(jnp.linalg.norm(v), tiny)
        A = A - 2.0 * jnp.outer(v, v @ A)
        vs.append(v)
    N = jnp.zeros((n, 4), dtype).at[5:, :].set(jnp.eye(4, dtype=dtype))
    for v in reversed(vs):  # N = H1 .. H5 [e5..e8]
        N = N - 2.0 * jnp.outer(v, v @ N)
    return N.T


def five_point_candidates(f0: jax.Array, f1: jax.Array):
    """Essential-matrix candidates from 5 bearing correspondences.

    Args:
      f0, f1: (5, 3) unit bearings with f0^T E f1 = 0.

    Returns:
      Es: (10, 3, 3) candidate essential matrices (Frobenius-normalised).
      valid: (10,) bool — real-root slots actually found.

    vmap over a leading hypothesis axis to solve many samples at once.
    """
    dtype = f0.dtype
    Q = jnp.einsum("ni,nj->nij", f0, f1).reshape(5, 9)
    # nullspace of the 5x9 constraint via 5 unrolled Householder
    # reflectors on Q^T (columns 5..8 of the implicit complete-QR factor
    # span null(Q)).  The generic jnp.linalg.qr(mode="complete") pair
    # (geqrf + orgqr) forms the full 9x9 factor through two library
    # kernels; this inline version is ~10 rank-1 updates that fuse into
    # the surrounding program.  Any orthonormal nullspace basis serves,
    # since the x E1 + y E2 + z E3 + E4 parameterisation only needs E4's
    # coefficient in the true E to be generically nonzero.
    Ebasis = _null4_of_5x9(Q).reshape(4, 3, 3)    # [E1, E2, E3, E4]

    A = _constraint_matrix(Ebasis)
    Bxy, Bc, det = _action_polynomials(A)
    roots, valid = real_roots(det, 10)

    def e_of_root(z):
        s = z / jnp.sqrt(1.0 + z * z)
        c = 1.0 / jnp.sqrt(1.0 + z * z)
        # rows scaled by c^4: [c * Bx_h, c * By_h, Bc_h]
        gxy = _eval_homog(Bxy, s[None, None], c[None, None])  # (3, 2)
        gc = _eval_homog(Bc, s[None], c[None])                # (3,)
        G = gxy * c
        # least-squares for [x, y]: closed-form 2x2 normal equations
        # (batched jnp.linalg.solve routes tiny systems through LU — a
        # measurable chunk of the solver's time at 40k roots/batch)
        H = G.T @ G + jnp.finfo(dtype).tiny * jnp.eye(2, dtype=dtype)
        b = -G.T @ gc
        det_h = H[0, 0] * H[1, 1] - H[0, 1] * H[1, 0]
        inv_det = 1.0 / jnp.where(det_h != 0.0, det_h, jnp.finfo(dtype).tiny)
        xy = jnp.stack([
            (H[1, 1] * b[0] - H[0, 1] * b[1]) * inv_det,
            (H[0, 0] * b[1] - H[1, 0] * b[0]) * inv_det,
        ])
        E = (xy[0] * Ebasis[0] + xy[1] * Ebasis[1]
             + z * Ebasis[2] + Ebasis[3])
        nrm = jnp.linalg.norm(E)
        return E / jnp.maximum(nrm, jnp.finfo(dtype).tiny)

    Es = jax.vmap(e_of_root)(roots)
    finite = jnp.all(jnp.isfinite(Es.reshape(10, 9)), axis=-1)
    return jnp.where(finite[:, None, None], Es, 0.0), valid & finite
