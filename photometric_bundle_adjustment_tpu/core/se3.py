"""Batched SO3/SE3 Lie-group primitives for JAX.

Batched replacement for the reference's Sophus usage (SE3d exp/log,
inverse, composition, ``Dx_this_mul_exp_x_at_0`` — see
/root/reference/thirdparty and its consumers, e.g.
include/visnav/local_parameterization_se3.hpp:43-63).  Everything here is a
pure function over arrays with arbitrary leading batch dimensions, safe under
``jit``/``vmap``/``jacfwd`` (all branches use NaN-safe ``where`` switches so
forward-mode derivatives stay finite at the small-angle branch points).

Conventions
-----------
* A pose is a ``(..., 7)`` array ``[tx, ty, tz, qx, qy, qz, qw]`` — the same
  quaternion convention as Sophus (serialised px..qw in the reference,
  include/visnav/serialization.h:156-164).
* A tangent vector is ``(..., 6)`` = ``[rho(3), phi(3)]`` (translational part
  first, rotational second — Sophus order).
* Retraction is **right-plus**: ``T_new = T * exp(delta)``, matching the
  Ceres ``LocalParameterizationSE3::Plus`` of the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# -----------------------------------------------------------------------------
# small-angle helpers
# -----------------------------------------------------------------------------


def _eps(dtype) -> float:
    return float(jnp.finfo(dtype).eps)


def _safe_div(num, den, small):
    """num/den with den replaced by 1 where ``small`` (result overridden by a
    Taylor branch there); keeps jacfwd free of NaNs from 0/0."""
    den_safe = jnp.where(small, jnp.ones_like(den), den)
    return num / den_safe


def hat_so3(phi: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = jnp.zeros_like(x)
    return jnp.stack(
        [
            jnp.stack([zero, -z, y], axis=-1),
            jnp.stack([z, zero, -x], axis=-1),
            jnp.stack([-y, x, zero], axis=-1),
        ],
        axis=-2,
    )


# -----------------------------------------------------------------------------
# quaternions (x, y, z, w)
# -----------------------------------------------------------------------------


def quat_identity(dtype=jnp.float64) -> jax.Array:
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_mul(q1: jax.Array, q2: jax.Array) -> jax.Array:
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_conj(q: jax.Array) -> jax.Array:
    return q * jnp.array([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


def quat_rotate(q: jax.Array, v: jax.Array) -> jax.Array:
    """Rotate vectors ``v`` (..., 3) by unit quaternions ``q`` (..., 4)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    one = jnp.ones_like(x)
    return jnp.stack(
        [
            jnp.stack([one - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), one - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), one - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def quat_from_matrix(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), branch-free.

    Uses the four-candidate construction; picks the numerically largest pivot
    with ``where`` so it vmaps/jits cleanly.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _stack(x, y, z, w):
        return jnp.stack([x, y, z, w], axis=-1)

    # candidates, each valid when its pivot is the largest
    qw_ = jnp.sqrt(jnp.maximum(1.0 + tr, 0.0)) / 2.0
    qx_ = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, 0.0)) / 2.0
    qy_ = jnp.sqrt(jnp.maximum(1.0 - m00 + m11 - m22, 0.0)) / 2.0
    qz_ = jnp.sqrt(jnp.maximum(1.0 - m00 - m11 + m22, 0.0)) / 2.0

    tiny = jnp.asarray(1e-30, R.dtype)
    cw = _stack((m21 - m12) / jnp.maximum(4 * qw_, tiny),
                (m02 - m20) / jnp.maximum(4 * qw_, tiny),
                (m10 - m01) / jnp.maximum(4 * qw_, tiny), qw_)
    cx = _stack(qx_, (m01 + m10) / jnp.maximum(4 * qx_, tiny),
                (m02 + m20) / jnp.maximum(4 * qx_, tiny),
                (m21 - m12) / jnp.maximum(4 * qx_, tiny))
    cy = _stack((m01 + m10) / jnp.maximum(4 * qy_, tiny), qy_,
                (m12 + m21) / jnp.maximum(4 * qy_, tiny),
                (m02 - m20) / jnp.maximum(4 * qy_, tiny))
    cz = _stack((m02 + m20) / jnp.maximum(4 * qz_, tiny),
                (m12 + m21) / jnp.maximum(4 * qz_, tiny), qz_,
                (m10 - m01) / jnp.maximum(4 * qz_, tiny))

    pivots = jnp.stack([qw_, qx_, qy_, qz_], axis=-1)
    idx = jnp.argmax(pivots, axis=-1)
    cands = jnp.stack([cw, cx, cy, cz], axis=-2)  # (..., 4cand, 4)
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32), axis=-2)
    return quat_normalize(q[..., 0, :])


# -----------------------------------------------------------------------------
# SO3 exp / log
# -----------------------------------------------------------------------------


def so3_exp(phi: jax.Array) -> jax.Array:
    """Axis-angle (..., 3) -> unit quaternion (..., 4)."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    small = theta2 < _eps(phi.dtype) ** 0.5 * 1e-3
    theta2_safe = jnp.where(small, jnp.zeros_like(theta2), theta2)
    theta = jnp.sqrt(jnp.where(small, jnp.ones_like(theta2), theta2_safe))
    half = 0.5 * theta
    # sin(theta/2)/theta: Taylor 1/2 - theta^2/48
    k = jnp.where(small, 0.5 - theta2 / 48.0, _safe_div(jnp.sin(half), theta, small))
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return jnp.concatenate([phi * k, w], axis=-1)


def so3_log(q: jax.Array) -> jax.Array:
    """Unit quaternion (..., 4) -> axis-angle (..., 3) with angle in [0, pi]."""
    # flip to the w >= 0 hemisphere: q and -q are the same rotation
    sign = jnp.where(q[..., 3:4] < 0, -jnp.ones_like(q[..., 3:4]), jnp.ones_like(q[..., 3:4]))
    q = q * sign
    qv = q[..., :3]
    w = q[..., 3:4]
    n2 = jnp.sum(qv * qv, axis=-1, keepdims=True)
    small = n2 < _eps(q.dtype) ** 0.5 * 1e-3
    n = jnp.sqrt(jnp.where(small, jnp.ones_like(n2), n2))
    # k = 2*atan2(n, w)/n ; Taylor (w ~ 1): 2/w - 2n^2/(3w^3)
    k_taylor = 2.0 / w - 2.0 * n2 / (3.0 * w**3)
    k_general = _safe_div(2.0 * jnp.arctan2(n, w), n, small)
    k = jnp.where(small, k_taylor, k_general)
    return qv * k


# -----------------------------------------------------------------------------
# SE3
# -----------------------------------------------------------------------------


def identity(dtype=jnp.float64) -> jax.Array:
    return jnp.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype)


def translation(T: jax.Array) -> jax.Array:
    return T[..., :3]


def rotation(T: jax.Array) -> jax.Array:
    return T[..., 3:7]


def make(t: jax.Array, q: jax.Array) -> jax.Array:
    return jnp.concatenate([t, q], axis=-1)


def from_matrix(M: jax.Array) -> jax.Array:
    """(..., 4, 4) or (..., 3, 4) homogeneous matrix -> (..., 7) pose."""
    return make(M[..., :3, 3], quat_from_matrix(M[..., :3, :3]))


def to_matrix(T: jax.Array) -> jax.Array:
    """(..., 7) pose -> (..., 4, 4) homogeneous matrix."""
    R = quat_to_matrix(rotation(T))
    t = translation(T)[..., None]
    top = jnp.concatenate([R, t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def compose(T1: jax.Array, T2: jax.Array) -> jax.Array:
    """T1 * T2."""
    q1, q2 = rotation(T1), rotation(T2)
    t = translation(T1) + quat_rotate(q1, translation(T2))
    return make(t, quat_normalize(quat_mul(q1, q2)))


def inverse(T: jax.Array) -> jax.Array:
    qinv = quat_conj(rotation(T))
    return make(-quat_rotate(qinv, translation(T)), qinv)


def act(T: jax.Array, p: jax.Array) -> jax.Array:
    """Apply pose to points: R p + t.  Broadcasts over leading dims."""
    return quat_rotate(rotation(T), p) + translation(T)


def _v_coeffs(phi: jax.Array):
    """Coefficients of V = I + a [phi]x + b [phi]x^2 used by se3 exp."""
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    small = theta2 < _eps(phi.dtype) ** 0.5 * 1e-3
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(
        small, 0.5 - theta2 / 24.0, _safe_div(1.0 - jnp.cos(theta), theta2_safe, small)
    )
    b = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        _safe_div(theta - jnp.sin(theta), theta2_safe * theta, small),
    )
    return a, b


def exp(xi: jax.Array) -> jax.Array:
    """se3 tangent (..., 6) = [rho, phi] -> pose (..., 7)."""
    rho = xi[..., :3]
    phi = xi[..., 3:6]
    q = so3_exp(phi)
    a, b = _v_coeffs(phi)
    Phix = hat_so3(phi)
    Vrho = (
        rho
        + a * jnp.einsum("...ij,...j->...i", Phix, rho)
        + b * jnp.einsum("...ij,...jk,...k->...i", Phix, Phix, rho)
    )
    return make(Vrho, q)


def log(T: jax.Array) -> jax.Array:
    """Pose (..., 7) -> se3 tangent (..., 6) = [rho, phi]."""
    phi = so3_log(rotation(T))
    t = translation(T)
    theta2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    small = theta2 < _eps(T.dtype) ** 0.5 * 1e-3
    theta2_safe = jnp.where(small, jnp.ones_like(theta2), theta2)
    theta = jnp.sqrt(theta2_safe)
    half = 0.5 * theta
    # c = 1/theta^2 - cos(theta/2) / (2 theta sin(theta/2)); Taylor: 1/12 + theta^2/720
    c_general = _safe_div(
        jnp.ones_like(theta2), theta2_safe, small
    ) - _safe_div(jnp.cos(half), 2.0 * theta * jnp.sin(half), small)
    c = jnp.where(small, 1.0 / 12.0 + theta2 / 720.0, c_general)
    Phix = hat_so3(phi)
    rho = (
        t
        - 0.5 * jnp.einsum("...ij,...j->...i", Phix, t)
        + c * jnp.einsum("...ij,...jk,...k->...i", Phix, Phix, t)
    )
    return jnp.concatenate([rho, phi], axis=-1)


def right_plus(T: jax.Array, delta: jax.Array) -> jax.Array:
    """Ceres-style manifold plus: T * exp(delta).

    Reference: LocalParameterizationSE3::Plus
    (include/visnav/local_parameterization_se3.hpp:43-50).
    """
    return compose(T, exp(delta))


def normalize(T: jax.Array) -> jax.Array:
    """Re-normalise the quaternion part (drift control after many updates)."""
    return make(translation(T), quat_normalize(rotation(T)))
