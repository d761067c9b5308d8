"""Synthetic BA problem generation — shared by tests, benchmarks, the
multi-chip dry-run, and the compile-check entry point."""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.core import cameras, se3
from photometric_bundle_adjustment_tpu.models import geometric_ba
from photometric_bundle_adjustment_tpu.models import photometric_ba as pba


def synth_ba_problem(
    model: str = "pinhole",
    K: int = 8,
    L: int = 256,
    obs_per_landmark: int = 4,
    seed: int = 0,
    pose_noise: float = 0.01,
    depth_noise: float = 0.03,
    pixel_noise: float = 0.0,
    dtype=jnp.float64,
):
    """Build a perturbed multi-view reprojection-BA problem with EuRoC-like
    geometry.  Returns (problem, poses_gt, inv_depth_gt)."""
    rng = np.random.default_rng(seed)
    intr = cameras.test_params(model, dtype=dtype)

    xi = np.zeros((K, 6))
    xi[:, 0] = np.arange(K) * 0.25
    xi[:, 1] = rng.normal(0, 0.05, K)
    xi[:, 3:] = rng.normal(0, 0.02, (K, 3))
    xi[0] = 0
    poses_gt = se3.exp(jnp.asarray(xi, dtype))

    pts = np.stack(
        [rng.uniform(-3, 3 + 0.25 * K, L), rng.uniform(-2, 2, L),
         rng.uniform(4, 12, L)],
        axis=-1,
    )
    pts_w = se3.act(poses_gt[0], jnp.asarray(pts, dtype))

    # anchor camera per landmark: nearest camera index (spread anchors)
    anchor_of_lm = rng.integers(0, max(K // 2, 1), L).astype(np.int32)
    T_anchor = poses_gt[anchor_of_lm]
    p_a = se3.act(se3.inverse(T_anchor), pts_w)
    uv_ref = cameras.project(model, intr, p_a)
    inv_depth_gt = 1.0 / jnp.linalg.norm(p_a, axis=-1)

    # observations: obs_per_landmark target cameras per landmark (anchor skipped)
    obs_a, obs_c, obs_l, uv_t_rows = [], [], [], []
    for j in range(obs_per_landmark):
        tgt = (anchor_of_lm + 1 + j) % K
        obs_a.append(anchor_of_lm)
        obs_c.append(tgt.astype(np.int32))
        obs_l.append(np.arange(L, dtype=np.int32))
        p_t = se3.act(se3.inverse(poses_gt[tgt]), pts_w)
        uv = cameras.project(model, intr, p_t)
        if pixel_noise > 0:
            uv = uv + rng.normal(0, pixel_noise, uv.shape)
        uv_t_rows.append(np.asarray(uv))
    O = L * obs_per_landmark

    # perturb initial state
    dpose = np.zeros((K, 6))
    dpose[2:] = rng.normal(0, pose_noise, (K - 2, 6))
    poses0 = jax.vmap(se3.right_plus)(poses_gt, jnp.asarray(dpose, dtype))
    rho0 = inv_depth_gt * (1.0 + rng.normal(0, depth_noise, L))

    problem = geometric_ba.build_problem(
        poses=poses0,
        inv_depth=jnp.asarray(rho0, dtype),
        anchor_cam=np.concatenate(obs_a),
        target_cam=np.concatenate(obs_c),
        landmark=np.concatenate(obs_l),
        uv_target=jnp.asarray(np.concatenate(uv_t_rows), dtype),
        uv_ref=jnp.tile(uv_ref, (obs_per_landmark, 1)),
        intr_ref=jnp.tile(intr, (O, 1)),
        intr_target=jnp.tile(intr, (O, 1)),
        valid=np.ones(O, bool),
        fixed_cams=np.arange(K) < 2,
    )
    return problem, poses_gt, inv_depth_gt


def synth_pba_problem(
    K: int = 4,
    L: int = 128,
    H: int = 64,
    W: int = 96,
    seed: int = 0,
    pose_noise: float = 0.003,
    depth_noise: float = 0.02,
    dtype=jnp.float32,
    model: str = "pinhole",
):
    """Photometric BA problem on a rendered curved (sphere) scene with a
    smooth texture, seen through a ``"pinhole"`` or double-sphere
    (``"ds"``, EuRoC-like distortion) camera.  Returns (problem,
    images_flat, H, W, poses_gt, inv_depth_gt)."""
    rng = np.random.default_rng(seed)
    dist = {"pinhole": (0.0, 0.0), "ds": (-0.2, 0.57)}[model]
    intr = jnp.array([0.8 * W, 0.8 * W, W / 2, H / 2, *dist, 0, 0], dtype)
    sphere_c = jnp.array([0.5, 0.0, 14.0], dtype)
    sphere_r = 9.5

    def texture(p_xy):
        x, y = p_xy[..., 0], p_xy[..., 1]
        return (
            120.0
            + 50.0 * jnp.sin(1.7 * x) * jnp.cos(2.3 * y)
            + 40.0 * jnp.sin(3.1 * x + 2.0 * y)
        )

    def ray_depth(o, dw):
        oc = o[None, :] - sphere_c[None, :]
        bq = jnp.sum(dw * oc, axis=-1)
        cq = jnp.sum(oc * oc, axis=-1) - sphere_r**2
        disc = jnp.sqrt(jnp.maximum(bq * bq - cq, 1e-9))
        return -bq - disc

    xi = np.zeros((K, 6))
    xi[:, 0] = np.arange(K) * 0.35
    xi[:, 1] = rng.normal(0, 0.04, K)
    xi[:, 3:] = rng.normal(0, 0.008, (K, 3))
    xi[0] = 0
    poses_gt = se3.exp(jnp.asarray(xi, dtype))

    def render(T_w_c):
        ys, xs = jnp.mgrid[0:H, 0:W]
        uv = jnp.stack([xs.astype(dtype), ys.astype(dtype)], -1)
        d = cameras.unproject_unit(model, intr, uv.reshape(-1, 2))
        o = se3.translation(T_w_c)
        dw = se3.quat_rotate(se3.rotation(T_w_c), d)
        lam = ray_depth(o, dw)
        p_w = o[None, :] + lam[:, None] * dw
        return texture(p_w[:, :2]).reshape(H, W)

    images = jnp.stack([render(poses_gt[k]) for k in range(K)])
    images_flat = images.reshape(-1)

    uv_ref = np.stack(
        [rng.uniform(8, W - 8, L), rng.uniform(8, H - 8, L)], -1
    ).astype(np.float64)
    d = cameras.unproject_unit(model, intr, jnp.asarray(uv_ref, dtype))
    o0 = se3.translation(poses_gt[0])
    dw = se3.quat_rotate(se3.rotation(poses_gt[0]), d)
    inv_depth_gt = 1.0 / ray_depth(o0, dw)
    ref_patch = pba.extract_ref_patches(
        images_flat, jnp.zeros(L, jnp.int32), jnp.asarray(uv_ref, dtype), H, W
    )

    obs_a = np.tile(np.zeros(L, np.int32), K - 1)
    obs_c = np.concatenate([np.full(L, k, np.int32) for k in range(1, K)])
    obs_l = np.tile(np.arange(L, dtype=np.int32), K - 1)
    O = L * (K - 1)

    dpose = np.zeros((K, 6))
    dpose[2:] = rng.normal(0, pose_noise, (K - 2, 6))
    poses0 = jax.vmap(se3.right_plus)(poses_gt, jnp.asarray(dpose, dtype))
    rho0 = inv_depth_gt * (1.0 + rng.normal(0, depth_noise, L))

    problem = pba.build_problem(
        poses=poses0,
        affine=jnp.zeros((K, 2), dtype),
        inv_depth=jnp.asarray(rho0, dtype),
        anchor_cam=obs_a,
        target_cam=obs_c,
        landmark=obs_l,
        uv_ref=jnp.tile(jnp.asarray(uv_ref, dtype), (K - 1, 1)),
        ref_patch=jnp.tile(ref_patch, (K - 1, 1)),
        target_img=obs_c,
        intr_ref=jnp.tile(intr, (O, 1)),
        intr_target=jnp.tile(intr, (O, 1)),
        valid=np.ones(O, bool),
        fixed_cams=np.arange(K) < 2,
    )
    return problem, images_flat, H, W, poses_gt, inv_depth_gt


def euroc_scale_pba_problem(K=164, L=4800, obs_per_lm=5, H=480, W=752,
                            seed=0, dtype=jnp.float32):
    """Photometric BA problem at EuRoC scale for throughput measurement:
    random images (content is irrelevant for timing), forward motion with
    small rotations, each landmark seen in the next ``obs_per_lm`` frames.
    Returns (problem, images_flat, H, W)."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (K, H, W)).astype(np.float32)
    images_flat = jnp.asarray(imgs.reshape(-1), dtype)

    intr = jnp.array([458.0, 457.0, W / 2, H / 2, 0, 0, 0, 0], dtype)
    xi = np.zeros((K, 6))
    xi[:, 0] = np.arange(K) * 0.05
    xi[:, 1:3] = rng.normal(0, 0.02, (K, 2))
    xi[:, 3:] = rng.normal(0, 0.01, (K, 3))
    poses = se3.exp(jnp.asarray(xi, dtype))

    anchor_of_lm = rng.integers(0, K - 8, L)
    uv_ref = np.stack(
        [rng.uniform(8, W - 8, L), rng.uniform(8, H - 8, L)], -1
    )
    inv_depth = 1.0 / rng.uniform(2.0, 12.0, L)

    obs_a, obs_c, obs_l = [], [], []
    for j in range(1, obs_per_lm + 1):
        obs_a.append(anchor_of_lm)
        obs_c.append(np.minimum(anchor_of_lm + j, K - 1))
        obs_l.append(np.arange(L))
    obs_a = np.concatenate(obs_a).astype(np.int32)
    obs_c = np.concatenate(obs_c).astype(np.int32)
    obs_l = np.concatenate(obs_l).astype(np.int32)
    O = obs_a.shape[0]

    ref_patch = pba.extract_ref_patches(
        images_flat, jnp.asarray(anchor_of_lm, jnp.int32),
        jnp.asarray(uv_ref, dtype), H, W,
    )
    problem = pba.build_problem(
        poses=poses,
        affine=jnp.zeros((K, 2), dtype),
        inv_depth=jnp.asarray(inv_depth, dtype),
        anchor_cam=obs_a,
        target_cam=obs_c,
        landmark=obs_l,
        uv_ref=jnp.asarray(uv_ref, dtype)[obs_l],
        ref_patch=ref_patch[obs_l],
        target_img=obs_c,
        intr_ref=jnp.tile(intr, (O, 1)),
        intr_target=jnp.tile(intr, (O, 1)),
        valid=np.ones(O, bool),
        fixed_cams=np.arange(K) < 2,
    )
    return problem, images_flat, H, W


# ---------------------------------------------------------------------------
# seeded EuRoC-shaped stereo sequence
# ---------------------------------------------------------------------------

_ARTIFACTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "refbaseline", "artifacts",
)
EUROC_CALIB = os.path.join(_ARTIFACTS, "ref_opt_calib.json")
EUROC_TRAJECTORY = os.path.join(_ARTIFACTS, "run_v1_trajectory.txt")

# Room (metres, world = cam-0 frame of frame 0, y down) enclosing the
# reference trajectory with >= 2 m to spare on every side.
_ROOM_LO = np.array([-3.2, -2.1, -6.2])
_ROOM_HI = np.array([6.6, 1.9, 3.6])
_TEXEL = 0.01  # metres per texel at mip level 0
_MIP_LEVELS = 7


def _quat_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def _pose_compose(T1: np.ndarray, T2: np.ndarray) -> np.ndarray:
    R1 = _quat_matrix(T1[3:])
    t = T1[:3] + (R1[:, 0] * T2[0] + R1[:, 1] * T2[1] + R1[:, 2] * T2[2])
    return np.concatenate([t, _quat_mul(T1[3:], T2[3:])])


def _pose_inverse(T: np.ndarray) -> np.ndarray:
    q = np.array([-T[3], -T[4], -T[5], T[6]])
    R = _quat_matrix(q)
    t = -(R[:, 0] * T[0] + R[:, 1] * T[1] + R[:, 2] * T[2])
    return np.concatenate([t, q])


def _bilinear(tex: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Clamped bilinear lookup of a 2-D array at texel coordinates."""
    h, w = tex.shape
    x = np.clip(x, 0.0, w - 1.0)
    y = np.clip(y, 0.0, h - 1.0)
    x0 = np.minimum(x.astype(np.int64), w - 2)
    y0 = np.minimum(y.astype(np.int64), h - 2)
    fx = x - x0
    fy = y - y0
    top = tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx
    bot = tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


def _wall_texture(rng, h: int, w: int) -> np.ndarray:
    """Corner-rich, non-repetitive texture: seeded value noise over five
    octaves (4 to 64 texels), with the mid octaves pushed through a soft
    threshold so that blob boundaries give sharp corners."""
    ys = np.arange(h, dtype=np.float64)
    xs = np.arange(w, dtype=np.float64)

    def octave(cell):
        g = rng.random((h // cell + 2, w // cell + 2))
        return _bilinear(g, xs[None, :] / cell, ys[:, None] / cell)

    blobs = octave(16) + 0.7 * octave(32) + 0.5 * octave(64) - 1.1
    blobs = blobs / (np.abs(blobs) + 0.08)          # soft threshold in (-1, 1)
    fine = octave(4) + 0.6 * octave(8) - 0.8
    tex = 128.0 + 70.0 * blobs + 45.0 * fine
    return np.clip(tex, 8.0, 247.0)


def _mip_pyramid(tex: np.ndarray) -> list:
    levels = [tex]
    for _ in range(_MIP_LEVELS - 1):
        t = levels[-1]
        h, w = (t.shape[0] // 2) * 2, (t.shape[1] // 2) * 2
        if h < 4 or w < 4:
            break
        t = t[:h, :w]
        levels.append(0.25 * (t[0::2, 0::2] + t[1::2, 0::2]
                              + t[0::2, 1::2] + t[1::2, 1::2]))
    return levels


def _ds_rays(intr: np.ndarray, H: int, W: int):
    """Unit camera-frame rays of every pixel of a double-sphere camera
    (camera_models.h:258-274) and each pixel's angular size."""
    fx, fy, cx, cy, xi, alpha = intr[:6]
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    mx = (u - cx) / fx
    my = (v - cy) / fy
    r2 = mx * mx + my * my
    mz = (1.0 - alpha * alpha * r2) / (
        alpha * np.sqrt(np.maximum(1.0 - (2.0 * alpha - 1.0) * r2, 0.0))
        + 1.0 - alpha
    )
    k = (mz * xi + np.sqrt(np.maximum(mz * mz + (1.0 - xi * xi) * r2, 0.0))) / (
        mz * mz + r2
    )
    rays = np.stack([k * mx, k * my, k * mz - xi], -1)
    rays = rays / np.sqrt(np.sum(rays * rays, -1, keepdims=True))
    du = np.sqrt(np.sum((rays[:, 1:] - rays[:, :-1]) ** 2, -1))
    dv = np.sqrt(np.sum((rays[1:] - rays[:-1]) ** 2, -1))
    ang = np.maximum(np.pad(du, ((0, 0), (0, 1)), mode="edge"),
                     np.pad(dv, ((0, 1), (0, 0)), mode="edge"))
    return rays, ang


def _render_room(T_w_c: np.ndarray, rays: np.ndarray, ang: np.ndarray,
                 faces: dict) -> np.ndarray:
    """Ray-cast one camera inside the textured box room, with trilinear
    mip-mapping by each pixel's footprint on the wall it hits."""
    R = _quat_matrix(T_w_c[3:])
    o = T_w_c[:3]
    rc = [rays[..., i] for i in range(3)]
    d = [R[i, 0] * rc[0] + R[i, 1] * rc[1] + R[i, 2] * rc[2] for i in range(3)]
    t_axis = []
    for a in range(3):
        da = np.where(np.abs(d[a]) < 1e-12, 1e-12, d[a])
        bound = np.where(da > 0, _ROOM_HI[a], _ROOM_LO[a])
        t_axis.append((bound - o[a]) / da)
    t_axis = np.stack(t_axis)
    axis = np.argmin(t_axis, 0)
    t = np.min(t_axis, 0)
    out = np.zeros(rays.shape[:2])
    for a in range(3):
        b, c = [i for i in range(3) if i != a]
        for side in (0, 1):
            m = (axis == a) & ((d[a] > 0) == bool(side))
            if not m.any():
                continue
            tm = t[m]
            pb = (o[b] + tm * d[b][m] - _ROOM_LO[b]) / _TEXEL
            pc = (o[c] + tm * d[c][m] - _ROOM_LO[c]) / _TEXEL
            cos = np.maximum(np.abs(d[a][m]), 0.2)
            fp = np.maximum(tm * ang[m] / (cos * _TEXEL), 1.0)
            mant, expo = np.frexp(fp)          # fp = mant * 2**expo, exact
            lo = expo - 1                      # 2**lo <= fp < 2**(lo + 1)
            w_hi = 2.0 * mant - 1.0
            pyr = faces[(a, side)]
            top = len(pyr) - 1
            val = np.zeros(tm.shape)
            for lvl in range(top + 1):
                for shift, wgt in ((0, 1.0 - w_hi), (1, w_hi)):
                    sel = np.minimum(lo + shift, top) == lvl
                    if not sel.any():
                        continue
                    s = float(2 ** lvl)
                    val[sel] += wgt[sel] * _bilinear(
                        pyr[lvl], (pb[sel] + 0.5) / s - 0.5,
                        (pc[sel] + 0.5) / s - 0.5,
                    )
            out[m] = val
    return out


def load_trajectory(path: str = EUROC_TRAJECTORY) -> dict:
    """{(frame, cam): (7,) T_w_c} from a reference trajectory dump."""
    poses = {}
    with open(path) as f:
        for line in f:
            tok = line.split()
            if tok and tok[0] == "CAMERA":
                poses[(int(tok[1]), int(tok[2]))] = np.array(
                    [float(x) for x in tok[3:10]]
                )
    return poses


def render_stereo_sequence(seed: int = 0, n_frames: int = 82):
    """See :func:`_render_stereo_sequence`; the last sequence rendered is
    kept (its images read-only), so a process that loads it twice renders
    it once."""
    images, timestamps, poses = _render_stereo_sequence(seed, n_frames)
    return dict(images), list(timestamps), dict(poses)


@functools.lru_cache(maxsize=1)
def _render_stereo_sequence(seed: int, n_frames: int):
    """EuRoC-shaped stereo sequence rendered from a seed, on the host.

    Cam-0 poses follow the reference EuRoC V1 trajectory
    (``refbaseline/artifacts/run_v1_trajectory.txt``); cam 1 sits at the
    reference calibration's ``T_i_c`` (0.11 m baseline), and both cameras
    use its double-sphere intrinsics at 752x480.  The scene is a box room
    whose six walls carry seeded multi-scale noise textures.  Only numpy
    arithmetic and ``sqrt`` are used, so the bytes do not depend on the
    machine.

    Returns ``(images, timestamps, poses)``: ``images`` and
    ``timestamps`` as ``io.dataset.load_images`` returns them, and
    ``poses`` the ground-truth ``{(frame, cam): (7,) T_w_c}``.
    """
    from photometric_bundle_adjustment_tpu.io import calib_io

    calib = calib_io.load_calibration(EUROC_CALIB)
    traj = load_trajectory()
    n_avail = len({f for f, _ in traj})
    if not 0 < n_frames <= n_avail:
        raise ValueError(f"n_frames must be in [1, {n_avail}], got {n_frames}")

    rng = np.random.default_rng(seed)
    size = np.round((_ROOM_HI - _ROOM_LO) / _TEXEL).astype(int) + 2
    faces = {}
    for a in range(3):
        b, c = [i for i in range(3) if i != a]
        for side in (0, 1):
            faces[(a, side)] = _mip_pyramid(_wall_texture(rng, size[c], size[b]))

    T_c0_c1 = _pose_compose(_pose_inverse(calib.T_i_c[0]), calib.T_i_c[1])
    cam_rays = []
    for cam in range(2):
        W, H = calib.widths[cam], calib.heights[cam]
        cam_rays.append(_ds_rays(np.asarray(calib.intrinsics[cam]), H, W))
    images, poses = {}, {}
    for fid in range(n_frames):
        T0 = traj[(fid, 0)]
        for cam, T in ((0, T0), (1, _pose_compose(T0, T_c0_c1))):
            rays, ang = cam_rays[cam]
            img = _render_room(T, rays, ang, faces)
            img = np.clip(np.rint(img), 0, 255).astype(np.uint8)
            img.flags.writeable = False
            images[(fid, cam)] = img
            poses[(fid, cam)] = T
    timestamps = [fid * 50_000_000 for fid in range(n_frames)]
    return images, timestamps, poses
