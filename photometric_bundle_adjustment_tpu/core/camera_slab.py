"""Slab-form (structure-of-planes) camera projection with analytic Jacobians.

The plane-layout geometric build (ops/geo_mega.py) evaluates the whole warp
chain in a transposed "plane" layout — every per-observation quantity is a
row of a ``(rows, O)`` array, so the observation axis is the long contiguous
one and no tiny trailing dims are ever padded.  This module provides the
camera-model piece of that layout: ``project_slab`` maps point
planes ``(qx, qy, qz)`` (each ``(P, O)``) plus an intrinsics slab
``(8, O)`` to pixel planes ``(u, v)`` AND the six projection-Jacobian
planes ``d(u,v)/d(x,y,z)`` in closed form (no autodiff, no ``(P, 2, 3)``
arrays).

Formulas mirror core/cameras.py, which mirrors the reference's
scalar-templated models (include/visnav/camera_models.h:44-421); the
Jacobians are hand-derived chain rules of those exact expressions and are
golden-tested against ``jax.jacfwd`` of ``cameras.project`` in
tests/test_cameras.py.  ``rot_planes`` and ``solve_lam`` are the plane-form
rotation and the reduced-camera-system solve the plane builds share.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _pinhole(intr, qx, qy, qz):
    fx, fy, cx, cy = intr[0:1], intr[1:2], intr[2:3], intr[3:4]
    iz = 1.0 / qz
    u = fx * qx * iz + cx
    v = fy * qy * iz + cy
    z0 = jnp.zeros_like(u)
    J00 = fx * iz
    J02 = -fx * qx * iz * iz
    J11 = fy * iz
    J12 = -fy * qy * iz * iz
    return u, v, (J00, z0, J02), (z0, J11, J12)


def _eucm(intr, qx, qy, qz):
    fx, fy, cx, cy = intr[0:1], intr[1:2], intr[2:3], intr[3:4]
    alpha, beta = intr[4:5], intr[5:6]
    r2 = qx * qx + qy * qy
    d = jnp.sqrt(beta * r2 + qz * qz)
    den = alpha * d + (1.0 - alpha) * qz
    id_ = 1.0 / d
    iden = 1.0 / den
    iden2 = iden * iden
    dden_x = alpha * beta * qx * id_
    dden_y = alpha * beta * qy * id_
    dden_z = alpha * qz * id_ + (1.0 - alpha)
    u = fx * qx * iden + cx
    v = fy * qy * iden + cy
    J00 = fx * iden - fx * qx * dden_x * iden2
    J01 = -fx * qx * dden_y * iden2
    J02 = -fx * qx * dden_z * iden2
    J10 = -fy * qy * dden_x * iden2
    J11 = fy * iden - fy * qy * dden_y * iden2
    J12 = -fy * qy * dden_z * iden2
    return u, v, (J00, J01, J02), (J10, J11, J12)


def _ds(intr, qx, qy, qz):
    fx, fy, cx, cy = intr[0:1], intr[1:2], intr[2:3], intr[3:4]
    xi, alpha = intr[4:5], intr[5:6]
    r2 = qx * qx + qy * qy
    d1 = jnp.sqrt(r2 + qz * qz)
    w = xi * d1 + qz
    d2 = jnp.sqrt(r2 + w * w)
    den = alpha * d2 + (1.0 - alpha) * w
    id1 = 1.0 / d1
    id2 = 1.0 / d2
    iden = 1.0 / den
    iden2 = iden * iden
    dw_x = xi * qx * id1
    dw_y = xi * qy * id1
    dw_z = xi * qz * id1 + 1.0
    dd2_x = (qx + w * dw_x) * id2
    dd2_y = (qy + w * dw_y) * id2
    dd2_z = w * dw_z * id2
    dden_x = alpha * dd2_x + (1.0 - alpha) * dw_x
    dden_y = alpha * dd2_y + (1.0 - alpha) * dw_y
    dden_z = alpha * dd2_z + (1.0 - alpha) * dw_z
    u = fx * qx * iden + cx
    v = fy * qy * iden + cy
    J00 = fx * iden - fx * qx * dden_x * iden2
    J01 = -fx * qx * dden_y * iden2
    J02 = -fx * qx * dden_z * iden2
    J10 = -fy * qy * dden_x * iden2
    J11 = fy * iden - fy * qy * dden_y * iden2
    J12 = -fy * qy * dden_z * iden2
    return u, v, (J00, J01, J02), (J10, J11, J12)


def _kb4(intr, qx, qy, qz):
    fx, fy, cx, cy = intr[0:1], intr[1:2], intr[2:3], intr[3:4]
    k1, k2, k3, k4 = intr[4:5], intr[5:6], intr[6:7], intr[7:8]
    r2 = qx * qx + qy * qy
    safe = r2 > 0.0
    r = jnp.sqrt(jnp.where(safe, r2, jnp.ones_like(r2)))
    ir = 1.0 / r
    n2 = r2 + qz * qz
    in2 = 1.0 / n2
    theta = jnp.arctan2(r, qz)
    t2 = theta * theta
    dth = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    dd = 1.0 + t2 * (
        3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4))
    )
    s = dth * ir
    dth_dx = dd * qz * in2 * qx * ir
    dth_dy = dd * qz * in2 * qy * ir
    dth_dz = -dd * r * in2
    ds_dx = ir * (dth_dx - s * qx * ir)
    ds_dy = ir * (dth_dy - s * qy * ir)
    ds_dz = ir * dth_dz
    u = jnp.where(safe, fx * s * qx + cx, jnp.broadcast_to(cx, r2.shape))
    v = jnp.where(safe, fy * s * qy + cy, jnp.broadcast_to(cy, r2.shape))
    # exact-center limit: s -> 1/z, d s/d(x,y) -> 0 (up to O(r)); matches the
    # autodiff-through-where limit used by the gather path closely enough
    # that the (measure-zero) r == 0 case never changes an LM decision.
    iz = 1.0 / qz
    J00 = jnp.where(safe, fx * (s + qx * ds_dx), fx * iz)
    J01 = jnp.where(safe, fx * qx * ds_dy, jnp.zeros_like(r2))
    J02 = jnp.where(safe, fx * qx * ds_dz, jnp.zeros_like(r2))
    J10 = jnp.where(safe, fy * qy * ds_dx, jnp.zeros_like(r2))
    J11 = jnp.where(safe, fy * (s + qy * ds_dy), fy * iz)
    J12 = jnp.where(safe, fy * qy * ds_dz, jnp.zeros_like(r2))
    return u, v, (J00, J01, J02), (J10, J11, J12)


_SLAB_MODELS = {
    "pinhole": _pinhole,
    "eucm": _eucm,
    "ds": _ds,
    "kb4": _kb4,
}


def project_slab(model: str, intr, qx, qy, qz):
    """Project point planes and return pixel planes + Jacobian planes.

    Args:
      model: one of "pinhole", "eucm", "ds", "kb4".
      intr: (8, N) intrinsics slab (rows fx, fy, cx, cy, p4..p7).
      qx, qy, qz: (..., N) point-component planes.

    Returns:
      (u, v, (J00, J01, J02), (J10, J11, J12)) — all shaped like ``qx``.
    """
    try:
        fn = _SLAB_MODELS[model]
    except KeyError:
        raise ValueError(
            f"Camera model {model!r} is not implemented. "
            f"Available: {sorted(_SLAB_MODELS)}"
        ) from None
    return fn(intr, qx, qy, qz)


def rot_planes(q):
    """Unit quaternion rows (N, 4) -> 3x3 list of (N,) rotation entries
    (same element formulas as se3.quat_to_matrix)."""
    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = jnp.ones_like(x)
    return [
        [one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)],
    ]


def solve_lam(neq, lam, free_cam_mask, cfg=None):
    """Per-lambda dense solve + back-substitution of a chunk-plan normal
    equation tuple (optim/fused.py build_chunk) for any camera tangent
    width."""
    H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0 = neq
    KC = H_cc_mat.shape[0]
    K = free_cam_mask.shape[0]
    C_ = KC // K
    dtype = g_c.dtype
    d_cc = jnp.clip(jnp.diagonal(H_cc_mat), 1e-12, 1e32)
    S = H_cc_mat + jnp.diag(lam * d_cc) - S_corr0 / (1.0 + lam)
    rhs = -(g_c.reshape(-1) - rhs_corr0 / (1.0 + lam))
    mask = jnp.repeat(free_cam_mask.astype(dtype), C_)
    S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
    cho = jax.scipy.linalg.cho_factor(S, lower=True)
    delta_c = jax.scipy.linalg.cho_solve(cho, rhs * mask) * mask
    delta_p = -(g_p + M @ delta_c) * inv0 / (1.0 + lam)
    return delta_c.reshape(K, C_), delta_p
