"""Photometric bundle adjustment (the pba2 capability).

Direct intensity-patch residuals with warping and affine brightness
transfer, DSO-style, on the same anchored-inverse-depth parameterisation as
the geometric BA (SURVEY §0: the warp
``p_target = pi(T_target_w * T_w_ref * pi^-1(p_ref) / rho)`` is identical;
only the residual changes from a 2-vector of pixels to an 8-pixel patch of
intensity differences).

Residual for one observation (landmark seen in target camera t, anchored in
reference camera r), per patch pixel k:

    r_k = ( I_t(pi_t(warp(uv_r + d_k, rho, T))) - b_t )
          - exp(a_t - a_r) * ( I_r(uv_r + d_k) - b_r )

with per-camera affine brightness parameters (a, b); camera blocks are
therefore 8-dimensional (6 SE3 + 2 affine) and landmark blocks stay scalar,
so the exact same Schur-complement LM core (optim/ba.py) solves it.

Image sampling is bilinear over a flat (K*H*W,) intensity buffer with
per-observation linear-index gathers (no per-observation image slices).  Forward-mode autodiff through the bilinear
weights yields the image-gradient chain term exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.core import cameras, se3
from photometric_bundle_adjustment_tpu.optim import ba

# DSO residual pattern: 8 pixels around the anchor
PATCH_OFFSETS = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    np.float64,
)
PATCH_SIZE = len(PATCH_OFFSETS)


class PhotometricObs(NamedTuple):
    uv_ref: jax.Array        # (2,) anchor pixel
    ref_patch: jax.Array     # (8,) reference intensities at uv_ref + offsets
    target_img: jax.Array    # () int32 image index of the target camera
    intr_ref: jax.Array      # (8,)
    intr_target: jax.Array   # (8,)


class PhotometricCams(NamedTuple):
    pose: jax.Array          # (K, 7)
    affine: jax.Array        # (K, 2) = (a, b)


def _gather_windows(images_flat: jax.Array, img_idx: jax.Array,
                    y0i: jax.Array, x0i: jax.Array, H: int, W: int):
    """Fetch the 4 bilinear taps as SCALAR gathers from the flat buffer.

    Returns (v00, v01, v10, v11), each shaped like ``y0i``.  XLA lowers
    a sliced (2, 2)-window gather per element with a per-slice overhead,
    so the four taps are separate scalar gathers.
    """
    base = img_idx.astype(jnp.int32) * (H * W)

    def at(yy, xx):
        return images_flat[base + yy * W + xx]

    return (
        at(y0i, x0i), at(y0i, x0i + 1),
        at(y0i + 1, x0i), at(y0i + 1, x0i + 1),
    )


def bilinear_sample_flat(
    images_flat: jax.Array, img_idx: jax.Array, uv: jax.Array, H: int, W: int
) -> jax.Array:
    """Bilinear sample I[img_idx](uv) from a flat (K*H*W,) buffer.

    uv: (..., 2) float pixel coordinates (x, y).  Out-of-bounds clamps.
    """
    x = jnp.clip(uv[..., 0], 0.0, W - 1.001)
    y = jnp.clip(uv[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    v00, v01, v10, v11 = _gather_windows(
        images_flat, img_idx, y0i, x0i, H, W
    )
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def bilinear_sample_and_grad(
    images_flat: jax.Array, img_idx: jax.Array, uv: jax.Array, H: int, W: int
):
    """Bilinear sample + analytic image gradient (dI/du, dI/dv)."""
    x = jnp.clip(uv[..., 0], 0.0, W - 1.001)
    y = jnp.clip(uv[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)
    v00, v01, v10, v11 = _gather_windows(
        images_flat, img_idx, y0i, x0i, H, W
    )
    val = (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )
    gx = (v01 - v00) * (1 - fy) + (v11 - v10) * fy
    gy = (v10 - v00) * (1 - fx) + (v11 - v01) * fx
    # saturate the gradient for clamped (out-of-image) samples, matching
    # autodiff-through-clip semantics: no pose update pressure from pixels
    # that fell off the image
    in_x = (uv[..., 0] >= 0.0) & (uv[..., 0] <= W - 1.001)
    in_y = (uv[..., 1] >= 0.0) & (uv[..., 1] <= H - 1.001)
    gx = jnp.where(in_x, gx, 0.0)
    gy = jnp.where(in_y, gy, 0.0)
    return val, gx, gy


# ---------------------------------------------------------------------------
# tile-based sampling
# ---------------------------------------------------------------------------
#
# The 8 projected patch pixels of one observation land within a few pixels
# of each other, so instead of 8 x 4 scalar HBM gathers per observation
# we can fetch ONE (TILE_H, TILE_W) tile per observation with a sliced
# gather of contiguous rows and resolve every bilinear tap as a dense
# two-tap weight contraction on the VPU:
#
#     val = wy^T  tile  wx,   gx = wy^T tile dwx,   gy = dwy^T tile wx
#
# where wx[c] = (c==x0)(1-fx) + (c==x0+1) fx etc. — exactly the 4-tap
# bilinear math with the irregular access replaced by dense FLOPs.  XLA
# lowers a sliced gather per ELEMENT, so the tile fetch moves 6x the
# elements of the per-tap path; scalar gathers therefore stay the default
# formulation ("gather"), and "tile" is kept as the reference semantics
# for a kernel that would stage a target image on chip and sample tiles
# from it.
# Pixels whose warp falls outside the tile (pathological stretch,
# > ~2.2x patch scale) clamp to the tile edge with zero gradient — the
# same treatment as out-of-image samples.

TILE_H = 12
TILE_W = 16


def _tile_sample_and_grad(images3d: jax.Array, img_idx: jax.Array,
                          uv: jax.Array, H: int, W: int):
    """Tile-gather bilinear sample + gradient for one observation.

    images3d: (Kimg, H, W); img_idx: () int32; uv: (P, 2) points that are
    mutually within a (TILE_H-3, TILE_W-3) span.  Returns (val, gx, gy),
    each (P,).
    """
    dtype = images3d.dtype
    x = jnp.clip(uv[..., 0], 0.0, W - 1.001)
    y = jnp.clip(uv[..., 1], 0.0, H - 1.001)
    y0b = jnp.clip(
        jnp.floor(jnp.min(y)).astype(jnp.int32) - 1, 0, H - TILE_H
    )
    x0b = jnp.clip(
        jnp.floor(jnp.min(x)).astype(jnp.int32) - 1, 0, W - TILE_W
    )
    tile = jax.lax.dynamic_slice(
        images3d, (img_idx.astype(jnp.int32), y0b, x0b), (1, TILE_H, TILE_W)
    )[0]

    # tile-relative coordinates; out-of-tile points clamp to the edge cell
    rx = jnp.clip(x - x0b.astype(dtype), 0.0, TILE_W - 1.001)
    ry = jnp.clip(y - y0b.astype(dtype), 0.0, TILE_H - 1.001)
    fx = rx - jnp.floor(rx)
    fy = ry - jnp.floor(ry)
    cx = jnp.floor(rx).astype(jnp.int32)
    cy = jnp.floor(ry).astype(jnp.int32)

    cols = jax.lax.broadcasted_iota(jnp.int32, (1, TILE_W), 1)
    rows = jax.lax.broadcasted_iota(jnp.int32, (1, TILE_H), 1)
    is_x0 = (cols == cx[:, None]).astype(dtype)        # (P, TILE_W)
    is_x1 = (cols == cx[:, None] + 1).astype(dtype)
    is_y0 = (rows == cy[:, None]).astype(dtype)        # (P, TILE_H)
    is_y1 = (rows == cy[:, None] + 1).astype(dtype)
    wx = is_x0 * (1.0 - fx[:, None]) + is_x1 * fx[:, None]
    wy = is_y0 * (1.0 - fy[:, None]) + is_y1 * fy[:, None]
    dwx = is_x1 - is_x0
    dwy = is_y1 - is_y0

    ty = wy @ tile                                     # (P, TILE_W)
    val = jnp.sum(ty * wx, axis=-1)
    gx = jnp.sum(ty * dwx, axis=-1)
    gy = jnp.sum((dwy @ tile) * wx, axis=-1)

    # zero gradient for clamped samples (off-image, or off-tile under a
    # pathological warp) — no pose-update pressure from invalid pixels
    in_x = (uv[..., 0] >= 0.0) & (uv[..., 0] <= W - 1.001) & \
        (x - x0b.astype(dtype) <= TILE_W - 1.001)
    in_y = (uv[..., 1] >= 0.0) & (uv[..., 1] <= H - 1.001) & \
        (y - y0b.astype(dtype) <= TILE_H - 1.001)
    gx = jnp.where(in_x, gx, 0.0)
    gy = jnp.where(in_y, gy, 0.0)
    return val, gx, gy


def make_rj_fn(model: str, images_flat: jax.Array, H: int, W: int,
               sampler: str = "gather"):
    """Closed-form residual + Jacobian (R=8, tangent 2*8+1=17).

    Pose/depth chain identical to the geometric warp (see
    geometric_ba.make_rj_fn) composed with the projection Jacobian and the
    analytic bilinear image gradient; affine-brightness partials in closed
    form.  Replaces 17 forward-mode passes through the sampler.

    ``sampler="gather"`` (default) uses per-tap scalar gathers — the
    fastest XLA formulation (see the note above _tile_sample_and_grad);
    ``"tile"`` uses the tile + tap-contraction path."""
    offsets = jnp.asarray(PATCH_OFFSETS)
    images3d = images_flat.reshape(-1, H, W)

    def rj(cam_a: PhotometricCams, cam_c: PhotometricCams,
           rho: jax.Array, aux: PhotometricObs):
        dtype = rho.dtype
        offs = offsets.astype(dtype)
        uv_patch = aux.uv_ref[None, :] + offs                     # (P, 2)
        d = cameras.unproject_unit(model, aux.intr_ref, uv_patch)  # (P, 3)
        Ra = se3.quat_to_matrix(se3.rotation(cam_a.pose))
        Rc = se3.quat_to_matrix(se3.rotation(cam_c.pose))
        t_a = se3.translation(cam_a.pose)
        t_c = se3.translation(cam_c.pose)
        # RAY-form warp q = M d + rho u (projection is scale-invariant;
        # no 1/rho anywhere — stable for near-infinity landmarks, see
        # geometric_ba.make_residual_fn)
        M = Rc.T @ Ra
        u = Rc.T @ (t_a - t_c)
        q = d @ M.T + rho * u                                      # (P, 3)

        def pi(p):
            return cameras.project(model, aux.intr_target, p)

        uv_t = pi(q)
        Jpi = jax.vmap(jax.jacfwd(pi))(q)                          # (P, 2, 3)
        if sampler == "tile":
            I_t, gx, gy = _tile_sample_and_grad(
                images3d, aux.target_img, uv_t, H, W
            )
        else:
            I_t, gx, gy = bilinear_sample_and_grad(
                images_flat,
                aux.target_img * jnp.ones((PATCH_SIZE,), jnp.int32),
                uv_t, H, W,
            )

        a_r, b_r = cam_a.affine[0], cam_a.affine[1]
        a_t, b_t = cam_c.affine[0], cam_c.affine[1]
        e = jnp.exp(a_t - a_r)
        ref_term = aux.ref_patch - b_r
        r = (I_t - b_t) - e * ref_term                              # (P,)

        # dI/dq = g^T Jpi : (P, 3)
        g = jnp.stack([gx, gy], axis=-1)                            # (P, 2)
        dIdy = jnp.einsum("pi,pij->pj", g, Jpi)

        eye = jnp.eye(3, dtype=dtype)
        # per-pixel dq blocks (P, 3, 13): [dt_a, dphi_a, dt_c, dphi_c, drho]
        # (q = rho p_c: rho times the p_c-form blocks — identical Jacobian
        # through the scale-invariant projection, no 1/rho)
        hat_d = se3.hat_so3(d)                                      # (P, 3, 3)
        hat_q = se3.hat_so3(q)
        Mb = jnp.broadcast_to(rho * M, (PATCH_SIZE, 3, 3))
        dpc = jnp.concatenate(
            [
                Mb,
                -jnp.einsum("ij,pjk->pik", M, hat_d),
                -jnp.broadcast_to(rho * eye, (PATCH_SIZE, 3, 3)),
                hat_q,
                jnp.broadcast_to(u, (PATCH_SIZE, 3))[:, :, None],
            ],
            axis=2,
        )                                                           # (P, 3, 13)
        J_geo = jnp.einsum("pj,pjk->pk", dIdy, dpc)                 # (P, 13)

        ones = jnp.ones((PATCH_SIZE,), dtype)
        # anchor affine: d r / d a_r = +e * ref_term ; d r / d b_r = +e
        Ja_aff = jnp.stack([e * ref_term, e * ones], axis=-1)       # (P, 2)
        # target affine: d r / d a_t = -e * ref_term ; d r / d b_t = -1
        Jc_aff = jnp.stack([-e * ref_term, -ones], axis=-1)

        # tangent layout per camera: [se3(6), a, b]
        J = jnp.concatenate(
            [
                J_geo[:, 0:6], Ja_aff,        # anchor block (8)
                J_geo[:, 6:12], Jc_aff,       # target block (8)
                J_geo[:, 12:13],              # rho
            ],
            axis=1,
        )                                                           # (P, 17)
        return r, J

    return rj


def make_residual_fn(model: str, images_flat: jax.Array, H: int, W: int,
                     sampler: str = "gather"):
    """Per-observation photometric residual (8,)."""
    offsets = jnp.asarray(PATCH_OFFSETS)
    images3d = images_flat.reshape(-1, H, W)

    def residual(cam_a: PhotometricCams, cam_c: PhotometricCams,
                 rho: jax.Array, aux: PhotometricObs):
        offs = offsets.astype(rho.dtype)
        uv_patch = aux.uv_ref[None, :] + offs                      # (8, 2)
        dirs = cameras.unproject_unit(model, aux.intr_ref, uv_patch)
        # RAY-form warp via quaternion rotations (see
        # geometric_ba.make_residual_fn for both the why and the how)
        qc_inv = se3.quat_conj(se3.rotation(cam_c.pose))
        t_rel = se3.translation(cam_a.pose) - se3.translation(cam_c.pose)
        q = se3.quat_rotate(
            qc_inv, se3.quat_rotate(se3.rotation(cam_a.pose), dirs)
        ) + rho * se3.quat_rotate(qc_inv, t_rel)
        uv_t = cameras.project(model, aux.intr_target, q)          # (8, 2)
        if sampler == "tile":
            I_t, _, _ = _tile_sample_and_grad(
                images3d, aux.target_img, uv_t, H, W
            )
        else:
            I_t = bilinear_sample_flat(
                images_flat, aux.target_img, uv_t, H, W
            )
        a_r, b_r = cam_a.affine[0], cam_a.affine[1]
        a_t, b_t = cam_c.affine[0], cam_c.affine[1]
        return (I_t - b_t) - jnp.exp(a_t - a_r) * (aux.ref_patch - b_r)

    return residual


def cam_retract(cam: PhotometricCams, delta: jax.Array) -> PhotometricCams:
    """8-dim camera tangent: [se3(6), da, db]."""
    return PhotometricCams(
        pose=se3.right_plus(cam.pose, delta[:6]),
        affine=cam.affine + delta[6:8],
    )


def make_solver(model: str, images_flat: jax.Array, H: int, W: int):
    return ba.make_ba_solver(
        make_residual_fn(model, images_flat, H, W), cam_retract, 8,
        rj_fn=make_rj_fn(model, images_flat, H, W),
    )


def make_fused_solver(model: str, images_flat: jax.Array, H: int, W: int):
    """Plan-based fused-assembly variant (optim.fused) — fastest single-device
    path; call as solve(problem, fused.plan_for_problem(problem), cfg)."""
    from photometric_bundle_adjustment_tpu.optim import fused

    return fused.make_fused_ba_solver(
        make_residual_fn(model, images_flat, H, W), cam_retract, 8,
        rj_fn=make_rj_fn(model, images_flat, H, W),
    )


def default_config() -> ba.BAConfig:
    # Huber on intensities (DSO uses ~9 greyvalues)
    return ba.BAConfig(max_iterations=20, huber_delta=9.0)


def build_problem(
    poses: jax.Array,         # (K, 7)
    affine: jax.Array,        # (K, 2)
    inv_depth: jax.Array,     # (L,)
    anchor_cam: jax.Array,    # (O,)
    target_cam: jax.Array,    # (O,)
    landmark: jax.Array,      # (O,)
    uv_ref: jax.Array,        # (O, 2)
    ref_patch: jax.Array,     # (O, 8)
    target_img: jax.Array,    # (O,) image index of target camera
    intr_ref: jax.Array,      # (O, 8)
    intr_target: jax.Array,   # (O, 8)
    valid: jax.Array,
    fixed_cams: jax.Array,
    lm_valid: jax.Array | None = None,
) -> ba.BAProblem:
    if lm_valid is None:
        lm_valid = jnp.ones(inv_depth.shape, bool)
    obs = ba.BAObservations(
        anchor_cam=jnp.asarray(anchor_cam, jnp.int32),
        target_cam=jnp.asarray(target_cam, jnp.int32),
        landmark=jnp.asarray(landmark, jnp.int32),
        aux=PhotometricObs(
            uv_ref=uv_ref,
            ref_patch=ref_patch,
            target_img=jnp.asarray(target_img, jnp.int32),
            intr_ref=intr_ref,
            intr_target=intr_target,
        ),
        valid=jnp.asarray(valid, inv_depth.dtype),
    )
    return ba.BAProblem(
        cam_states=PhotometricCams(pose=poses, affine=affine),
        inv_depth=inv_depth,
        obs=obs,
        fixed_cams=jnp.asarray(fixed_cams, bool),
        lm_valid=jnp.asarray(lm_valid, bool),
    )


def extract_ref_patches(
    images_flat: jax.Array, img_idx: jax.Array, uv_ref: jax.Array,
    H: int, W: int,
) -> jax.Array:
    """Sample the 8-pixel reference patches for all landmarks: (L, 8)."""
    offs = jnp.asarray(PATCH_OFFSETS, uv_ref.dtype)
    uv = uv_ref[:, None, :] + offs[None, :, :]
    return bilinear_sample_flat(
        images_flat, img_idx[:, None] * jnp.ones((1, PATCH_SIZE), jnp.int32),
        uv, H, W,
    )


# ---------------------------------------------------------------------------
# image pyramids (coarse-to-fine photometric optimisation)
# ---------------------------------------------------------------------------


def downsample2(images: jax.Array) -> jax.Array:
    """2x2 average-pool downsampling of (K, H, W) image stacks."""
    K, H, W = images.shape
    H2, W2 = H // 2, W // 2
    x = images[:, : H2 * 2, : W2 * 2].reshape(K, H2, 2, W2, 2)
    return x.mean(axis=(2, 4))


def build_pyramid(images: jax.Array, levels: int = 3):
    """Returns [(images_l, H_l, W_l)] for levels 0..levels-1 (0 = full res)."""
    out = []
    cur = images
    for _ in range(levels):
        K, H, W = cur.shape
        out.append((cur, H, W))
        cur = downsample2(cur)
    return out


def scale_intrinsics(intr: jax.Array, level: int) -> jax.Array:
    """Intrinsics for pyramid level ``level`` (pixel (0,0) is the center of
    the top-left pixel): f' = f/2^l, c' = (c + 0.5)/2^l - 0.5."""
    s = float(2**level)
    return (
        intr.at[..., 0].divide(s)
        .at[..., 1].divide(s)
        .at[..., 2].set((intr[..., 2] + 0.5) / s - 0.5)
        .at[..., 3].set((intr[..., 3] + 0.5) / s - 0.5)
    )


def scale_problem_to_level(problem: ba.BAProblem, level: int) -> ba.BAProblem:
    """Rescale a level-0 photometric problem's pixel quantities to a coarser
    pyramid level (anchor pixels + both intrinsics); ``ref_patch`` must be
    re-extracted from the level's reference images by the caller."""
    if level == 0:
        return problem
    s = float(2**level)
    aux = problem.obs.aux
    aux = aux._replace(
        uv_ref=(aux.uv_ref + 0.5) / s - 0.5,
        intr_ref=scale_intrinsics(aux.intr_ref, level),
        intr_target=scale_intrinsics(aux.intr_target, level),
    )
    return problem._replace(obs=problem.obs._replace(aux=aux))
