"""Camera calibration: full-batch NLLS over per-frame body poses, per-camera
extrinsics, and intrinsics on an AprilGrid sequence.

Batched re-design of the reference calibration app
(src/calibration.cpp:366-428): residual per detected grid corner

    r = p_2d - pi( T_i_c^-1 * T_w_i^-1 * p_grid_3d )

(ReprojectionCostFunctor, reprojection.h:47-72), with camera-0 extrinsics
held fixed (calibration.cpp:386-388).  All corners across all frames/cams
are one flat residual array; the Jacobian is taken by ``jacfwd`` through the
product-manifold retraction, and the dense normal equations are solved by
the generic LM core (SPARSE_NORMAL_CHOLESKY replacement — the parameter
count is a few hundred, so a dense on-chip solve is faster than any
sparsity bookkeeping).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.core import cameras, se3
from photometric_bundle_adjustment_tpu.optim import LMConfig, lm_solve


def aprilgrid_corners_3d(
    tag_cols: int = 6,
    tag_rows: int = 6,
    tag_size: float = 0.088,
    tag_spacing: float = 0.3,
) -> np.ndarray:
    """3D corner layout of the 6x6 AprilGrid (aprilgrid.h:39-72)."""
    x_off = [0.0, tag_size, tag_size, 0.0]
    y_off = [0.0, 0.0, tag_size, tag_size]
    pts = np.zeros((tag_cols * tag_rows * 4, 3))
    for y in range(tag_cols):
        for x in range(tag_rows):
            tag_id = tag_rows * y + x
            xo = x * tag_size * (1 + tag_spacing)
            yo = y * tag_size * (1 + tag_spacing)
            for i in range(4):
                pts[(tag_id << 2) + i] = [xo + x_off[i], yo + y_off[i], 0.0]
    return pts


class CalibParams(NamedTuple):
    T_w_i: jax.Array        # (F, 7) body-to-world per frame
    T_i_c: jax.Array        # (num_cams, 7) camera-to-body
    intrinsics: jax.Array   # (num_cams, 8)


class CalibData(NamedTuple):
    frame_idx: jax.Array    # (R,) int32
    cam_idx: jax.Array      # (R,) int32
    p_3d: jax.Array         # (R, 3) grid corner position
    uv: jax.Array           # (R, 2) detected pixel


def build_data(corners: dict, frame_ids: list[int], grid3d: np.ndarray) -> CalibData:
    """Flatten {(frame, cam): {corners, corner_ids}} into arrays.  frame_ids
    maps frame number -> contiguous index."""
    fmap = {f: i for i, f in enumerate(frame_ids)}
    fi, ci, p3, uv = [], [], [], []
    for (frame, cam), d in sorted(corners.items()):
        if frame not in fmap:
            continue
        n = len(d["corner_ids"])
        fi.append(np.full(n, fmap[frame], np.int32))
        ci.append(np.full(n, cam, np.int32))
        p3.append(grid3d[d["corner_ids"]])
        uv.append(d["corners"])
    return CalibData(
        frame_idx=jnp.asarray(np.concatenate(fi)),
        cam_idx=jnp.asarray(np.concatenate(ci)),
        p_3d=jnp.asarray(np.concatenate(p3)),
        uv=jnp.asarray(np.concatenate(uv)),
    )


def make_residual_fn(model: str, data: CalibData):
    def residuals(params: CalibParams) -> jax.Array:
        T_w_i = params.T_w_i[data.frame_idx]
        T_i_c = params.T_i_c[data.cam_idx]
        intr = params.intrinsics[data.cam_idx]
        p_c = se3.act(se3.inverse(T_i_c), se3.act(se3.inverse(T_w_i), data.p_3d))
        r = data.uv - cameras.project(model, intr, p_c)
        return r.reshape(-1)

    return residuals


def make_retract(F: int, num_cams: int):
    """Tangent layout: [F*6 body poses | num_cams*6 extrinsics |
    num_cams*8 intrinsics]."""
    D = F * 6 + num_cams * 6 + num_cams * 8

    def retract(params: CalibParams, delta: jax.Array) -> CalibParams:
        d_wi = delta[: F * 6].reshape(F, 6)
        d_ic = delta[F * 6 : F * 6 + num_cams * 6].reshape(num_cams, 6)
        d_in = delta[F * 6 + num_cams * 6 :].reshape(num_cams, 8)
        return CalibParams(
            T_w_i=jax.vmap(se3.right_plus)(params.T_w_i, d_wi),
            T_i_c=jax.vmap(se3.right_plus)(params.T_i_c, d_ic),
            intrinsics=params.intrinsics + d_in,
        )

    return retract, D


def fixed_mask(F: int, num_cams: int, optimize_intrinsics: bool = True) -> np.ndarray:
    """cam0 extrinsics always fixed (calibration.cpp:386-388)."""
    D = F * 6 + num_cams * 6 + num_cams * 8
    m = np.zeros(D, bool)
    m[F * 6 : F * 6 + 6] = True
    if not optimize_intrinsics:
        m[F * 6 + num_cams * 6 :] = True
    return m


def calibrate(
    model: str,
    data: CalibData,
    init: CalibParams,
    max_iterations: int = 50,
):
    """Run the calibration NLLS; tolerances follow calibration.cpp:410-414
    (0.01 * eps)."""
    eps = float(jnp.finfo(init.T_w_i.dtype).eps)
    F = init.T_w_i.shape[0]
    num_cams = init.T_i_c.shape[0]
    residuals = make_residual_fn(model, data)
    retract, D = make_retract(F, num_cams)
    cfg = LMConfig(
        max_iterations=max_iterations,
        function_tolerance=0.01 * eps,
        gradient_tolerance=0.01 * eps,
        parameter_tolerance=0.0,
    )
    mask = jnp.asarray(fixed_mask(F, num_cams))
    return lm_solve(residuals, init, retract, D, cfg, fixed_mask=mask)
