"""Two-view geometry: essential matrix, epipolar test, midpoint
triangulation.  Batched/vmappable replacements for the OpenGV pieces the
reference consumes (matching_utils.h:51-79, map_utils.h:168-191)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from photometric_bundle_adjustment_tpu.core import se3


def skew(v: jax.Array) -> jax.Array:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


def essential_from_pose(T_0_1: jax.Array) -> jax.Array:
    """E = [t_hat]_x R from the relative pose (computeEssential,
    matching_utils.h:51-60; translation normalised)."""
    t = se3.translation(T_0_1)
    t = t / jnp.linalg.norm(t, axis=-1, keepdims=True)
    R = se3.quat_to_matrix(se3.rotation(T_0_1))
    return skew(t) @ R


def epipolar_inliers(
    bearings0: jax.Array,
    bearings1: jax.Array,
    E: jax.Array,
    threshold: float = 1e-3,
) -> jax.Array:
    """|x_L^T E x_R| <= threshold per match (findInliersEssential,
    matching_utils.h:62-79).  Returns bool mask."""
    err = jnp.abs(jnp.einsum("...i,ij,...j->...", bearings0, E, bearings1))
    return err <= threshold


def triangulate_midpoint(
    f0: jax.Array, f1: jax.Array, T_0_1: jax.Array
) -> jax.Array:
    """Midpoint triangulation in frame 0 (OpenGV triangulation::triangulate
    as used at map_utils.h:177-178).

    f0, f1: (..., 3) unit bearings in camera 0 / camera 1; T_0_1 the pose of
    camera 1 in camera-0 coordinates.  Returns points (..., 3) in frame 0.
    """
    R = se3.quat_to_matrix(se3.rotation(T_0_1))
    t = se3.translation(T_0_1)
    Rf1 = jnp.einsum("...ij,...j->...i", R, f1)
    # least-squares on [f0, -Rf1] [l0, l1]^T = t  (2x2 normal equations)
    a = jnp.sum(f0 * f0, axis=-1)
    b = -jnp.sum(f0 * Rf1, axis=-1)
    c = jnp.sum(Rf1 * Rf1, axis=-1)
    e0 = jnp.sum(f0 * t, axis=-1)
    e1 = -jnp.sum(Rf1 * t, axis=-1)
    det = a * c - b * b
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    l0 = (c * e0 - b * e1) / det
    l1 = (a * e1 - b * e0) / det
    p0 = l0[..., None] * f0
    p1 = t + l1[..., None] * Rf1
    return 0.5 * (p0 + p1)


def reprojection_angle_error(
    f0: jax.Array, f1: jax.Array, T_0_1: jax.Array
) -> jax.Array:
    """OpenGV relative-pose SAC error: triangulate, reproject into both
    cameras, return (1 - cos a0) + (1 - cos a1)."""
    p0 = triangulate_midpoint(f0, f1, T_0_1)
    p1 = se3.act(se3.inverse(T_0_1), p0)
    n0 = p0 / jnp.maximum(jnp.linalg.norm(p0, axis=-1, keepdims=True), 1e-12)
    n1 = p1 / jnp.maximum(jnp.linalg.norm(p1, axis=-1, keepdims=True), 1e-12)
    e0 = 1.0 - jnp.sum(f0 * n0, axis=-1)
    e1 = 1.0 - jnp.sum(f1 * n1, axis=-1)
    return e0 + e1


def _cofactor3(A: jax.Array) -> jax.Array:
    """Cofactor matrix of a 3x3: rows are cross products of row pairs
    (cof(A) = adj(A)^T; A @ adj(A) = det(A) I)."""
    return jnp.stack([
        jnp.cross(A[1], A[2]),
        jnp.cross(A[2], A[0]),
        jnp.cross(A[0], A[1]),
    ])


def _orthonormalize_rows(R: jax.Array) -> jax.Array:
    """Project a near-rotation onto SO(3) by row Gram-Schmidt + cross."""
    eps = jnp.asarray(1e-30, R.dtype)
    r0 = R[0] / jnp.maximum(jnp.linalg.norm(R[0]), eps)
    r1 = R[1] - jnp.dot(R[1], r0) * r0
    r1 = r1 / jnp.maximum(jnp.linalg.norm(r1), eps)
    r2 = jnp.cross(r0, r1)
    return jnp.stack([r0, r1, r2])


def decompose_essential(E: jax.Array):
    """E -> 4 candidate relative poses (R, t), each (4, 3, 3) / (4, 3).

    Closed-form, SVD-free: for a true essential matrix E = [t]_x R with
    unit singular values, t is the unit left-null vector (computed as the
    largest cross product of column pairs) and R = cof(E) - [t]_x E
    (adj(AB) = adj(B) adj(A) with adj([t]_x) = t t^T gives
    cof(E) = t t^T R, and [t]_x [t]_x = t t^T - I).  Decomposing -E gives
    the second rotation; the sign ambiguity of t enumerates the rest —
    exactly the four SVD candidates U W^(T) V^T, (+-)u3.  Batched small
    SVDs are iterative Jacobi sweeps on accelerators; this is a handful
    of fused elementwise ops.  Inputs
    only approximately essential (polynomial-solver candidates) get a
    final Gram-Schmidt projection onto SO(3).
    """
    dtype = E.dtype
    eps = jnp.asarray(1e-30, dtype)
    # scale to unit nonzero singular values: ||E||_F^2 = 2 for essential
    En = E * jnp.sqrt(2.0 / jnp.maximum(jnp.sum(E * E), eps))
    c0, c1, c2 = En[:, 0], En[:, 1], En[:, 2]
    cand = jnp.stack([jnp.cross(c0, c1), jnp.cross(c1, c2),
                      jnp.cross(c2, c0)])
    norms = jnp.linalg.norm(cand, axis=1)
    t = cand[jnp.argmax(norms)]
    t = t / jnp.maximum(jnp.linalg.norm(t), eps)
    cof = _cofactor3(En)
    SE = skew(t) @ En
    Ra = _orthonormalize_rows(cof - SE)
    Rb = _orthonormalize_rows(cof + SE)
    Rs = jnp.stack([Ra, Ra, Rb, Rb])
    ts = jnp.stack([t, -t, t, -t])
    return Rs, ts


def eight_point(f0: jax.Array, f1: jax.Array) -> jax.Array:
    """Essential matrix from >= 8 bearing correspondences such that
    f0^T E f1 = 0; rank-2 projection included.  f0/f1: (n, 3)."""
    A = jnp.einsum("ni,nj->nij", f0, f1).reshape(f0.shape[0], 9)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=True)
    E = Vt[-1].reshape(3, 3)
    U, s, Vt2 = jnp.linalg.svd(E)
    s_avg = 0.5 * (s[0] + s[1])
    return U @ jnp.diag(jnp.array([s_avg, s_avg, 0.0], E.dtype)) @ Vt2
