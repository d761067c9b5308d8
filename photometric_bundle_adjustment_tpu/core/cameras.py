"""Batched camera projection models.

Batched re-design of the reference's scalar-templated camera class
hierarchy (include/visnav/camera_models.h:44-525).  Four models on a uniform
``(8,)`` parameter vector, selected by name string — "pinhole", "eucm",
"ds", "kb4" — with batched ``project``/``unproject`` that broadcast over
arbitrary leading point dimensions.  All functions are jit/vmap/jacfwd-safe.

The kb4 unprojection inverts the distortion polynomial with the same 5
fixed Newton iterations as the reference (camera_models.h:372-375), written
as an unrolled loop so forward-mode autodiff flows through it; a
``custom_jvp`` applies the implicit-function theorem instead of
differentiating the iteration, which keeps Jacobians exact at convergence.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

N_PARAMS = 8

# ---------------------------------------------------------------------------
# pinhole  (camera_models.h:48-114)
# ---------------------------------------------------------------------------


def pinhole_project(params: jax.Array, p: jax.Array) -> jax.Array:
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return jnp.stack([fx * x / z + cx, fy * y / z + cy], axis=-1)


def pinhole_unproject(params: jax.Array, uv: jax.Array) -> jax.Array:
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    v = jnp.stack([mx, my, jnp.ones_like(mx)], axis=-1)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# extended unified  (camera_models.h:117-196)
# ---------------------------------------------------------------------------


def eucm_project(params: jax.Array, p: jax.Array) -> jax.Array:
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    alpha, beta = params[..., 4], params[..., 5]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d = jnp.sqrt(beta * (x * x + y * y) + z * z)
    denom = alpha * d + (1.0 - alpha) * z
    return jnp.stack([fx * x / denom + cx, fy * y / denom + cy], axis=-1)


def eucm_unproject(params: jax.Array, uv: jax.Array) -> jax.Array:
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    alpha, beta = params[..., 4], params[..., 5]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    mz = (1.0 - beta * alpha * alpha * r2) / (
        alpha * jnp.sqrt(jnp.maximum(1.0 - (2.0 * alpha - 1.0) * beta * r2, 0.0))
        + (1.0 - alpha)
    )
    v = jnp.stack([mx, my, mz], axis=-1)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# double sphere  (camera_models.h:199-284)
# ---------------------------------------------------------------------------


def ds_project(params: jax.Array, p: jax.Array) -> jax.Array:
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    xi, alpha = params[..., 4], params[..., 5]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d1 = jnp.sqrt(x * x + y * y + z * z)
    xi_d1_z = xi * d1 + z
    d2 = jnp.sqrt(x * x + y * y + xi_d1_z * xi_d1_z)
    denom = alpha * d2 + (1.0 - alpha) * xi_d1_z
    return jnp.stack([fx * x / denom + cx, fy * y / denom + cy], axis=-1)


def ds_unproject(params: jax.Array, uv: jax.Array) -> jax.Array:
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    xi, alpha = params[..., 4], params[..., 5]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    mz = (1.0 - alpha * alpha * r2) / (
        alpha * jnp.sqrt(jnp.maximum(1.0 - (2.0 * alpha - 1.0) * r2, 0.0)) + 1.0 - alpha
    )
    factor = (mz * xi + jnp.sqrt(jnp.maximum(mz * mz + (1.0 - xi * xi) * r2, 0.0))) / (
        mz * mz + r2
    )
    # NOTE: the reference returns this *unnormalised* (camera_models.h:272-274);
    # every call site normalises afterwards, and so do our consumers.
    return jnp.stack([factor * mx, factor * my, factor * mz - xi], axis=-1)


# ---------------------------------------------------------------------------
# Kannala-Brandt 4  (camera_models.h:287-421)
# ---------------------------------------------------------------------------


def _kb4_dtheta(k: jax.Array, theta: jax.Array) -> jax.Array:
    k1, k2, k3, k4 = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    t2 = theta * theta
    return theta + t2 * theta * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))


def _kb4_ddtheta(k: jax.Array, theta: jax.Array) -> jax.Array:
    k1, k2, k3, k4 = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    t2 = theta * theta
    return 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (7.0 * k3 + t2 * 9.0 * k4)))


def kb4_project(params: jax.Array, p: jax.Array) -> jax.Array:
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k = params[..., 4:8]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r2 = x * x + y * y
    at_center = r2 == 0.0
    r = jnp.sqrt(jnp.where(at_center, jnp.ones_like(r2), r2))
    theta = jnp.arctan2(r, z)
    d_theta = _kb4_dtheta(k, theta)
    u = jnp.where(at_center, cx, fx * d_theta * x / r + cx)
    v = jnp.where(at_center, cy, fy * d_theta * y / r + cy)
    return jnp.stack([u, v], axis=-1)


@jax.custom_jvp
def _kb4_theta_from_ru(k: jax.Array, r_u: jax.Array) -> jax.Array:
    """Solve d(theta) = r_u for theta: 5 Newton steps from 0, as in the
    reference (camera_models.h:372-375)."""
    theta = jnp.zeros_like(r_u)
    for _ in range(5):
        theta = theta - (_kb4_dtheta(k, theta) - r_u) / _kb4_ddtheta(k, theta)
    return theta


@_kb4_theta_from_ru.defjvp
def _kb4_theta_jvp(primals, tangents):
    # implicit function theorem on f(theta) = d(theta) - r_u = 0:
    #   dtheta = (dr_u - d_k d(theta) . dk) / d'(theta)
    k, r_u = primals
    dk, dr_u = tangents
    theta = _kb4_theta_from_ru(k, r_u)
    dd = _kb4_ddtheta(k, theta)
    t2 = theta * theta
    t3 = t2 * theta
    # partials of d(theta) w.r.t. k1..k4 at fixed theta
    dpoly = jnp.stack([t3, t3 * t2, t3 * t2 * t2, t3 * t2 * t2 * t2], axis=-1)
    dtheta = (dr_u - jnp.sum(dpoly * dk, axis=-1)) / dd
    return theta, dtheta


def kb4_unproject(params: jax.Array, uv: jax.Array) -> jax.Array:
    fx, fy, cx, cy = params[..., 0], params[..., 1], params[..., 2], params[..., 3]
    k = params[..., 4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r2 = mx * mx + my * my
    at_center = r2 == 0.0
    r_u = jnp.sqrt(jnp.where(at_center, jnp.ones_like(r2), r2))
    theta = _kb4_theta_from_ru(k, r_u)
    s = jnp.sin(theta) / r_u
    x = jnp.where(at_center, jnp.zeros_like(mx), s * mx)
    y = jnp.where(at_center, jnp.zeros_like(my), s * my)
    z = jnp.where(at_center, jnp.ones_like(mx), jnp.cos(theta))
    return jnp.stack([x, y, z], axis=-1)


# ---------------------------------------------------------------------------
# registry / dispatch  (AbstractCamera::from_data, camera_models.h:452-474)
# ---------------------------------------------------------------------------

MODELS: dict[str, tuple[Callable, Callable]] = {
    "pinhole": (pinhole_project, pinhole_unproject),
    "eucm": (eucm_project, eucm_unproject),
    "ds": (ds_project, ds_unproject),
    "kb4": (kb4_project, kb4_unproject),
}

MODEL_IDS = {name: i for i, name in enumerate(MODELS)}


def _lookup(model: str):
    try:
        return MODELS[model]
    except KeyError:
        raise ValueError(
            f"Camera model {model!r} is not implemented. "
            f"Available: {sorted(MODELS)}"
        ) from None


def project(model: str, params: jax.Array, p: jax.Array) -> jax.Array:
    return _lookup(model)[0](params, p)


def unproject(model: str, params: jax.Array, uv: jax.Array) -> jax.Array:
    return _lookup(model)[1](params, uv)


def unproject_unit(model: str, params: jax.Array, uv: jax.Array) -> jax.Array:
    """Unproject and normalise to a unit bearing vector (the reference always
    calls ``.normalize()`` on unprojections at use sites, e.g.
    map_utils.h:158-161, reprojection.h:107)."""
    v = unproject(model, params, uv)
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


def initialize(model: str, ds_intrinsics: jax.Array) -> jax.Array:
    """Initialise an 8-vector for ``model`` from double-sphere-style
    intrinsics, mirroring AbstractCamera::initialize
    (camera_models.h:477-519)."""
    p = jnp.asarray(ds_intrinsics)
    if model == "ds":
        return p
    p = p.at[4:].set(0.0)
    if model == "eucm":
        p = p.at[4].set(0.5).at[5].set(1.0)
    return p


def test_params(model: str, dtype=jnp.float64) -> jax.Array:
    """The reference's hard-coded test intrinsics (``getTestProjections``,
    camera_models.h:60-66, 134-140, 211-218, 300-307) — used as golden
    fixtures in our tests."""
    vals = {
        "pinhole": [0.5 * 805, 0.5 * 800, 505, 509, 0, 0, 0, 0],
        "eucm": [0.5 * 500, 0.5 * 500, 319.5, 239.5, 0.51231234, 0.9, 0, 0],
        "ds": [0.5 * 805, 0.5 * 800, 505, 509, 0.5 * -0.150694, 0.5 * 1.48785, 0, 0],
        "kb4": [379.045, 379.008, 505.512, 509.969, 0.00693023, -0.0013828,
                -0.000272596, -0.000452646],
    }
    return jnp.array(vals[model], dtype=dtype)


@functools.partial(jax.jit, static_argnames=("model",))
def project_batch(model: str, params: jax.Array, pts: jax.Array) -> jax.Array:
    return project(model, params, pts)
