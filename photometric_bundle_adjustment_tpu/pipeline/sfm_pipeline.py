"""Incremental stereo SfM pipeline: the host-side state machine.

Re-design of the reference driver (src/sfm.cpp:1117-2131): the same staged
pipeline — detect -> match(stereo, then all-pairs or BoW) -> tracks -> init
scene -> {candidates -> add cameras -> add landmarks -> optimize -> remove
outliers}* -> done — with the same two-tier candidate policy, outlier
taxonomy, and thresholds, but with every per-pixel / per-observation /
per-pair computation batched onto the device:

  * feature extraction: jitted detection+description per image,
  * all-pairs matching: pairs processed in vmapped chunks (descriptor
    matching + vectorised 8-point RANSAC in one compiled computation per
    chunk) — the analog of the reference's TBB parallel_for fan-out
    (sfm.cpp:1294-1319) mapped onto the chip instead of threads,
  * BA: the Schur-complement LM solver on struct-of-array views of the map,
  * projections/outlier flags: one batched kernel over all observations.

Bookkeeping (tracks, candidate sorting, stage logic) stays on the host in
plain dicts — it is O(matches) pointer-chasing, not flops.
"""

from __future__ import annotations

import contextlib
import functools
import os
import pickle
import time
from dataclasses import dataclass, field
from enum import Enum

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.core import cameras as cam_models
from photometric_bundle_adjustment_tpu.core import se3
from photometric_bundle_adjustment_tpu.features import (
    describe,
    detect,
    geometry,
    match,
    ransac,
)
from photometric_bundle_adjustment_tpu.models import geometric_ba
from photometric_bundle_adjustment_tpu.optim import ba
from photometric_bundle_adjustment_tpu.pipeline import tracks as tracks_mod
from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
from photometric_bundle_adjustment_tpu.utils.shapes import bucket as _bucket


class Stage(Enum):
    """CameraCandidates::Stage (common_types.h:240-247)."""

    COMPUTE_CANDIDATES = 0
    ADD_CAMERAS = 1
    ADD_LANDMARKS = 2
    OPTIMIZE = 3
    REMOVE_OUTLIERS = 4
    DONE = 5


# outlier flags (common_types.h:276-286)
OUTLIER_NONE = 0
OUTLIER_REPROJECTION_HUGE = 1 << 0
OUTLIER_REPROJECTION_NORMAL = 1 << 1
OUTLIER_CAMERA_DISTANCE = 1 << 2
OUTLIER_Z_COORDINATE = 1 << 3


@dataclass
class Landmark:
    inv_depth: float
    obs: dict                      # {fcid: feature_id}
    outlier_obs: dict = field(default_factory=dict)

    def anchor(self):
        """First observation in FrameCamId order = the reference frame
        (obs.begin() on the ordered map, map_utils.h:351-352)."""
        return min(self.obs)

    def add_obs(self, fcid, feat):
        """Record an observation AND invalidate the sorted-obs cache —
        the one sanctioned mutation path for ``obs`` (advisor round-4:
        an in-place overwrite of an existing fcid would keep the
        count-keyed cache stale; routing every write through here keys
        correctness on the call site, not on the count)."""
        self.obs[fcid] = feat
        self._obs_cache = None

    def sorted_obs_arrays(self):
        """(fcid keys, feature ids) of ``obs`` in FrameCamId order, as
        int64 arrays with fcid encoded frame*16+cam — cached; invalidated
        by :meth:`add_obs` (the sole mutation path) and re-checked by
        observation count as a belt-and-braces fallback.  Feeds the
        vectorised BA-problem assembly (round-4 host profile: the per-row
        Python scan was ~12 s of a full run)."""
        c = getattr(self, "_obs_cache", None)
        if c is None or c[0] != len(self.obs):
            items = sorted(self.obs.items())
            n = len(items)
            keys = np.fromiter(
                (f * 16 + cam for (f, cam), _ in items), np.int64, n
            )
            feats = np.fromiter((ft for _, ft in items), np.int64, n)
            self._obs_cache = (n, keys, feats)
            c = self._obs_cache
        return c[1], c[2]


@dataclass
class Candidate:
    fcid: tuple
    shared_tracks: list
    tried: bool = False
    camera_added: bool = False
    landmarks_added: bool = False


# ------------------------------------------------------------------------
# Bucketed batch kernels for the per-item geometry the incremental loop
# does between BA solves.  Row counts vary every call, so callers pad to
# power-of-two buckets (edge-repeat padding keeps every row numerically
# benign) and these compile once per bucket instead of once per call.


@functools.partial(jax.jit, static_argnames=("model",))
def _lm_positions_kernel(model, uv, intr, T, rho):
    """Batched Landmark::get_p (common_types.h:205-217)."""
    d = cam_models.unproject_unit(model, intr, uv)
    return se3.act(T, d / rho[:, None])


@functools.partial(jax.jit, static_argnames=("model",))
def _project_rows_kernel(model, uv_meas, intr, T, p_w):
    """Batched reprojection with error/distance/z outputs
    (compute_projections, sfm.cpp:1957-2008)."""
    p_c = se3.act(se3.inverse(T), p_w)
    uv_proj = cam_models.project(model, intr, p_c)
    err = jnp.linalg.norm(uv_meas - uv_proj, axis=-1)
    dist = jnp.linalg.norm(p_c, axis=-1)
    return uv_proj, err, dist, p_c[:, 2]


@functools.partial(jax.jit, static_argnames=("model",))
def _project_obs_kernel(model, uv_a, intr_a, T_a, rho,
                        uv_meas, intr_t, T_t):
    """Landmark::get_p + reprojection fused into one dispatch: the outlier
    pass previously paid two device round trips per pass (one
    _lm_positions_kernel, one _project_rows_kernel).

    Returns ONE packed (M, 5) array [uv_proj, err, dist, z] so the caller
    pays a single device->host fetch instead of four."""
    d = cam_models.unproject_unit(model, intr_a, uv_a)
    p_w = se3.act(T_a, d / rho[:, None])
    p_c = se3.act(se3.inverse(T_t), p_w)
    uv_proj = cam_models.project(model, intr_t, p_c)
    err = jnp.linalg.norm(uv_meas - uv_proj, axis=-1)
    dist = jnp.linalg.norm(p_c, axis=-1)
    return jnp.concatenate(
        [uv_proj, err[:, None], dist[:, None], p_c[:, 2:3]], axis=1
    )


@functools.partial(jax.jit, static_argnames=("model", "min_cos"))
def _triangulate_rows_kernel(model, uv0, uv1, intr0, intr1, T0, T1, min_cos):
    """Batched two-view midpoint triangulation + parallax gate
    (add_new_landmarks_between_cams, map_utils.h:121-195)."""
    f0 = cam_models.unproject_unit(model, intr0, uv0)
    f1 = cam_models.unproject_unit(model, intr1, uv1)
    T_0_1 = se3.compose(se3.inverse(T0), T1)
    p0 = geometry.triangulate_midpoint(f0, f1, T_0_1)
    inv_depth = 1.0 / jnp.linalg.norm(p0, axis=-1)
    Rf1 = se3.quat_rotate(se3.rotation(T_0_1), f1)
    cos_ang = jnp.sum(f0 * Rf1, axis=-1)
    ok = (cos_ang < min_cos) & jnp.isfinite(inv_depth) & (inv_depth > 0)
    return inv_depth, ok


@functools.partial(
    jax.jit, static_argnames=("model", "min_cos", "spec")
)
def _triangulate_rows_packed(model, buffers, min_cos, spec):
    """Packed-buffer front of :func:`_triangulate_rows_kernel` with
    intrinsics compacted to per-row uint8 indices; returns ONE (M, 2)
    array [inv_depth, ok] (one byte-buffer upload + one fetch per call)."""
    from photometric_bundle_adjustment_tpu.utils import pack as pack_mod

    uv0, uv1, i0, i1, intr_tab, T0, T1 = pack_mod.unpack_tree_bytes(
        buffers, spec
    )
    inv_depth, ok = _triangulate_rows_kernel(
        model, uv0, uv1, intr_tab[i0], intr_tab[i1], T0, T1, min_cos
    )
    return jnp.stack([inv_depth, ok.astype(inv_depth.dtype)], axis=1)


@functools.partial(jax.jit, static_argnames=("model", "spec"))
def _project_obs_packed(model, buffers, spec):
    """Packed-buffer front of :func:`_project_obs_kernel` (same single
    (M, 5) packed output; intrinsics ride as uint8 row indices)."""
    from photometric_bundle_adjustment_tpu.utils import pack as pack_mod

    uv_a, ia, T_a, rho, uv_meas, it_, T_t, intr_tab = (
        pack_mod.unpack_tree_bytes(buffers, spec)
    )
    return _project_obs_kernel(
        model, uv_a, intr_tab[ia], T_a, rho, uv_meas, intr_tab[it_], T_t
    )


def _pad_rows(x: np.ndarray, M: int) -> np.ndarray:
    """Pad the leading axis to M by repeating the last row."""
    n = x.shape[0]
    if n == M:
        return x
    return np.concatenate([x, np.repeat(x[-1:], M - n, axis=0)])


@functools.partial(jax.jit, static_argnames=("model",))
def _bearings_kernel(model, intr, uv):
    """Jitted feature-bearing computation (eager unproject dispatches each
    of its ~15 ops separately)."""
    return cam_models.unproject_unit(model, intr, uv)


@functools.partial(jax.jit, static_argnames=("num",))
def _split_keys(key, num: int):
    """Jitted PRNG split: one dispatch instead of one per eager op."""
    return jax.random.split(key, num)


@jax.jit
def _pack_ba_out(cam_states, inv_depth, cost, initial_cost, lam,
                 iterations):
    """Pack a BA solve's outputs into ONE array: one device->host fetch
    per solve instead of five (poses, depths, and three scalars for the
    log line)."""
    dt = cam_states.dtype
    return jnp.concatenate([
        cam_states.reshape(-1),
        inv_depth.astype(dt),
        jnp.stack([cost.astype(dt), initial_cost.astype(dt),
                   lam.astype(dt), iterations.astype(dt)]),
    ])


@jax.jit
def _stereo_geometry(T_c0, T_c1):
    """Stereo extrinsics + essential matrix in one jitted dispatch (the
    eager formulation dispatched every tiny se3 op separately)."""
    T_0_1 = se3.compose(se3.inverse(T_c0), T_c1)
    return T_0_1, geometry.essential_from_pose(T_0_1)


@functools.partial(
    jax.jit, static_argnames=("model", "pixel_threshold", "num_hypotheses")
)
def _localize_kernel(model, uv, intr, points, valid, key,
                     pixel_threshold, num_hypotheses):
    """Unproject + PnP RANSAC in one compiled program (localize_camera,
    map_utils.h:242-302); all shapes bucketed by the caller."""
    bearings = cam_models.unproject_unit(
        model, jnp.broadcast_to(intr, (uv.shape[0],) + intr.shape), uv
    )
    return ransac.ransac_pnp(
        bearings, points, valid, key,
        pixel_threshold=pixel_threshold, num_hypotheses=num_hypotheses,
    )


@functools.partial(
    jax.jit, static_argnames=("model", "pixel_threshold", "num_hypotheses")
)
def _localize_batch_kernel(model, uv, intr, uv_a, intr_a, T_a, rho,
                           valid, keys, pixel_threshold, num_hypotheses):
    """vmapped PnP localization over a candidate axis with Landmark::get_p
    FUSED in (anchor unprojection -> world point -> RANSAC): one device
    dispatch localizes a whole WAVE of camera candidates, with no separate
    landmark-positions round trip."""

    def one(uv1, intr1, uva1, intra1, Ta1, rho1, val1, k1):
        d = cam_models.unproject_unit(model, intra1, uva1)
        pts1 = se3.act(Ta1, d / rho1[:, None])
        bearings = cam_models.unproject_unit(
            model, jnp.broadcast_to(intr1, (uv1.shape[0],) + intr1.shape),
            uv1,
        )
        T1, inl1 = ransac.ransac_pnp(
            bearings, pts1, val1, k1,
            pixel_threshold=pixel_threshold, num_hypotheses=num_hypotheses,
        )
        # packed (7 + M,) row: one fetch per wave instead of two
        return jnp.concatenate([T1, inl1.astype(T1.dtype)])

    return jax.vmap(one)(uv, intr, uv_a, intr_a, T_a, rho, valid, keys)


@functools.partial(
    jax.jit,
    static_argnames=("model", "pixel_threshold", "num_hypotheses", "spec"),
)
def _localize_batch_packed(model, buffers, keys, pixel_threshold,
                           num_hypotheses, spec):
    """Packed-buffer front of :func:`_localize_batch_kernel`: the wave's
    seven input arrays ride as ONE byte buffer (utils/pack) instead of
    seven host->device transfers."""
    from photometric_bundle_adjustment_tpu.utils import pack as pack_mod

    uv, intr, uv_a, intr_a, T_a, rho, valid = pack_mod.unpack_tree_bytes(
        buffers, spec
    )
    return _localize_batch_kernel(
        model, uv, intr, uv_a, intr_a, T_a, rho, valid, keys,
        pixel_threshold, num_hypotheses,
    )



def outlier_policy(tid_k: np.ndarray, fl: np.ndarray):
    """Vectorised outlier-removal policy over the contiguous per-track
    observation rows (sfm.cpp:2028-2131 scan loop): scan each track's
    records in insertion order; the first record that triggers removal
    decides the counter (per-record priority huge > normal > distance >
    z; normal triggers removal only when no severe flag exists anywhere).
    Returns (removed_tids, n_huge, n_normal, n_dist, n_z, any_severe) —
    bit-identical to the scalar loop (tests/test_pipeline.py runs a
    randomized differential check against the scalar oracle)."""
    n_normal = n_huge = n_dist = n_z = 0
    removed: list = []
    any_severe = bool(np.any(fl & ~OUTLIER_REPROJECTION_NORMAL))
    m = len(fl)
    if m:
        HUGE = OUTLIER_REPROJECTION_HUGE
        NORM = OUTLIER_REPROJECTION_NORMAL
        DIST = OUTLIER_CAMERA_DISTANCE
        ZC = OUTLIER_Z_COORDINATE
        starts = np.flatnonzero(np.r_[True, tid_k[1:] != tid_k[:-1]])
        seg_len = np.diff(np.r_[starts, m])
        seg_tids = tid_k[starts]
        stop_bits = (HUGE | DIST | ZC) if any_severe else (
            HUGE | NORM | DIST | ZC
        )
        pos = np.arange(m)
        stop_pos = np.where((fl & stop_bits) != 0, pos, m)
        first_stop = np.minimum.reduceat(stop_pos, starts)
        has_stop = first_stop < m
        cfl = fl[np.minimum(first_stop, m - 1)]
        cause_huge = has_stop & ((cfl & HUGE) != 0)
        rest = has_stop & ~cause_huge
        if any_severe:
            cause_dist = rest & ((cfl & DIST) != 0)
            cause_z = rest & ~cause_dist & ((cfl & ZC) != 0)
            # normal_counted: a NORMAL record seen strictly before the
            # stop, or on the stop record itself unless the scan broke at
            # its huge check first
            fs_exp = np.repeat(first_stop, seg_len)
            ch_exp = np.repeat(cause_huge, seg_len)
            elig = ((fl & NORM) != 0) & (
                (pos < fs_exp) | ((pos == fs_exp) & ~ch_exp)
            )
            n_normal = int(np.logical_or.reduceat(elig, starts).sum())
        else:
            cause_norm = rest & ((cfl & NORM) != 0)
            cause_dist = rest & ~cause_norm & ((cfl & DIST) != 0)
            cause_z = (rest & ~cause_norm & ~cause_dist
                       & ((cfl & ZC) != 0))
            n_normal = int(cause_norm.sum())
        n_huge = int(cause_huge.sum())
        n_dist = int(cause_dist.sum())
        n_z = int(cause_z.sum())
        removed = [int(t) for t in seg_tids[has_stop]]
    return removed, n_huge, n_normal, n_dist, n_z, any_severe


class SfmPipeline:
    def __init__(self, images: dict, calib, cfg: SfmConfig = SfmConfig(),
                 cache_dir: str | None = None, seed: int = 0,
                 log=print, params_file: str | None = None):
        self.params_file = params_file
        self._params_mtime = None
        self.images = images          # {(frame, cam): (H, W) uint8}
        self.calib = calib            # io.calib_io.Calibration
        self.cfg = cfg
        self.model = calib.cam_types[0] if calib.cam_types else "ds"
        self.cache_dir = cache_dir
        self.log = log
        self.key = jax.random.PRNGKey(seed)
        self.fcids = sorted(images)
        self.num_frames = len({f for (f, _) in self.fcids})

        # map state
        self.corners: dict = {}
        self.matches: dict = {}
        self.tracks: dict = {}
        self.outlier_tracks: dict = {}
        self.cameras: dict = {}
        self.landmarks: dict = {}
        self.candidates: list[Candidate] = []
        self.stage = Stage.COMPUTE_CANDIDATES
        self.min_localization_inliers = 0
        self.max_cameras_to_add = 0
        self.image_projections: dict = {}
        self.timings: dict = {}
        # per-stage wall spent in device dispatch+fetch blocks (same keys
        # as ``timings``): stage host bookkeeping = timings[k] -
        # timings_dev[k].  apps.sfm writes both so the end-to-end wall
        # story can name the host hotspots per stage.
        self.timings_dev: dict = {}
        # wall spent in device dispatch+fetch blocks (see _dev); host
        # bookkeeping = total wall - device_seconds
        self.device_seconds = 0.0
        # device-kernel invocation counts (workload accounting for the
        # keyframes/s composite bench — bench.py build_keyframes_workload)
        self.counters: dict = {}

        self._stacked = None  # device-side stacked features

    # ---------------------------------------------------------------- utils

    def _next_key(self):
        self.key, sub = _split_keys(self.key, 2)
        return sub

    def _next_keys(self, n: int):
        """n keys in ONE jitted device dispatch (jax.random.split is a
        device computation; drawing per-chunk keys one at a time costs one
        dispatch each, 416 for the all-pairs stage)."""
        ks = _split_keys(self.key, n + 1)
        self.key = ks[0]
        return ks[1:]

    def _count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    @contextlib.contextmanager
    def _dev(self):
        """Accumulate wall time of device dispatch+fetch blocks into
        ``device_seconds``: host bookkeeping is then
        total wall minus this — the decomposition apps.sfm records for
        bench.py's end-to-end wall estimate."""
        t0 = time.time()
        try:
            yield
        finally:
            self.device_seconds += time.time() - t0

    def _uv_table(self):
        """All detected keypoint uv rows concatenated once (corners are
        static after detection) + per-image base offsets: per-row lookups
        become one fancy index instead of 10^6-scale np.stack-of-(2,)
        calls (round-4 host profile)."""
        key = (id(self.corners), len(self.corners))
        if getattr(self, "_uvt_key", None) != key:
            offs = {}
            parts = []
            base = 0
            for fcid, c in self.corners.items():
                uv = c["uv"]
                offs[fcid] = base
                parts.append(uv)
                base += uv.shape[0]
            self._uvt = (np.concatenate(parts, axis=0) if parts
                         else np.zeros((0, 2)))
            self._uvt_off = offs
            self._uvt_key = key
        return self._uvt, self._uvt_off

    def _pose_table(self):
        """Current camera poses stacked (K, 7) + fcid -> row map (poses
        change every BA cycle, so this is rebuilt per call — O(K))."""
        pose_of = {}
        rowsl = []
        for i, (f, T) in enumerate(self.cameras.items()):
            pose_of[f] = i
            rowsl.append(np.asarray(T))
        tab = np.stack(rowsl) if rowsl else np.zeros((0, 7))
        return tab, pose_of

    def _anchor_arrays(self, tids: list):
        """Host-side per-row anchor data (uv, intr, T, rho) for
        Landmark::get_p — shared by landmark_positions and the fused
        project-observations kernel."""
        uvf, off = self._uv_table()
        pose_tab, pose_of = self._pose_table()
        # per-UNIQUE-tid scalars (callers pass one tid per observation
        # row, so the anchor min()/lookups would otherwise repeat ~5x)
        cache: dict = {}
        uvidx, cam_l, pose_l, rho_l = [], [], [], []
        for t in tids:
            e = cache.get(t)
            if e is None:
                lm = self.landmarks[t]
                a = min(lm.obs)
                e = (off[a] + lm.obs[a], a[1], pose_of[a], lm.inv_depth)
                cache[t] = e
            uvidx.append(e[0])
            cam_l.append(e[1])
            pose_l.append(e[2])
            rho_l.append(e[3])
        uv = uvf[np.asarray(uvidx)]
        rho = np.asarray(rho_l)
        T = pose_tab[np.asarray(pose_l)]
        intr = np.asarray(self.calib.intrinsics)[np.asarray(cam_l)]
        return uv, intr, T, rho

    def landmark_positions(self, tids: list) -> np.ndarray:
        """Batched Landmark::get_p (common_types.h:205-217); bucketed so the
        kernel compiles once per power-of-two row count."""
        if not tids:
            return np.zeros((0, 3))
        uv, intr, T, rho = self._anchor_arrays(tids)
        N = len(tids)
        M = _bucket(N, 256)
        self._count("lmpos_calls")
        self._count(f"lmpos_rows_{M}")
        with self._dev():
            p_w = _lm_positions_kernel(
                self.model,
                jnp.asarray(_pad_rows(uv, M)),
                jnp.asarray(_pad_rows(intr, M)),
                jnp.asarray(_pad_rows(T, M)),
                jnp.asarray(_pad_rows(rho[:, None], M)[:, 0]),
            )
            out = np.asarray(p_w)
        return out[:N]

    # ------------------------------------------------------------ stage 1-2

    def detect_keypoints(self, batch: int = 8):
        """Whole-dataset detection+description in ONE device dispatch
        (lax.map over vmapped sub-batches): one upload of the image stack,
        one fetch of all features, instead of a dispatch and a fetch per
        batch."""
        t0, d0 = time.time(), self.device_seconds
        self.clear_keypoints()
        F = self.cfg.num_features_per_image
        N = len(self.fcids)
        if N == 0:
            self._stage_mark("detect", t0, d0)
            return
        shape = next(iter(self.images.values())).shape
        Np = -(-N // batch) * batch  # zero-pad: padded images yield no corners
        stack = np.zeros((Np,) + shape, np.asarray(
            next(iter(self.images.values()))).dtype)
        for i, f in enumerate(self.fcids):
            stack[i] = self.images[f]
        self._count("detect_batches", Np // batch)
        self._count("detect_dispatches")
        with self._dev():
            uv, valid, angles, desc = jax.tree_util.tree_map(
                np.asarray,
                describe.detect_and_describe_all(
                    jnp.asarray(stack), batch=batch, num_features=F,
                    rotate_features=self.cfg.rotate_features,
                ),
            )
        for i, fcid in enumerate(self.fcids):
            self.corners[fcid] = {
                "uv": uv[i], "valid": valid[i],
                "angles": angles[i], "desc": desc[i],
            }
        self._stage_mark("detect", t0, d0)
        self._save_cache("corners")
        self.log(f"Detected keypoints in {len(self.fcids)} images "
                 f"({self.timings['detect']:.1f}s)")

    def _stack_features(self):
        if self._stacked is not None:
            return self._stacked
        uv_np = np.stack([self.corners[f]["uv"] for f in self.fcids])
        valid_np = np.stack([self.corners[f]["valid"] for f in self.fcids])
        desc_np = np.stack([self.corners[f]["desc"] for f in self.fcids])
        # Compact the feature axis to the actual detection count: detection
        # fills slots score-descending (valid first), and on EuRoC the 0.01
        # quality gate yields ~350-450 corners — matching at the padded
        # 1500 slots would do (1500/450)^2 ~ 11x redundant Hamming work per
        # pair.  Round to the 128-lane so every matcher shape stays tiled.
        n_valid = int(valid_np.sum(1).max()) if valid_np.size else 0
        Fc = max(128, -(-n_valid // 128) * 128)
        if Fc < uv_np.shape[1]:
            uv_np = uv_np[:, :Fc]
            valid_np = valid_np[:, :Fc]
            desc_np = desc_np[:, :Fc]
        cam_ids = np.array([c for (_, c) in self.fcids])
        with self._dev():   # upload + bearing kernel (and its compile)
            uv = jnp.asarray(uv_np)
            valid = jnp.asarray(valid_np)
            desc = jnp.asarray(desc_np)
            intr = jnp.asarray(np.asarray(self.calib.intrinsics)[cam_ids])
            bear = _bearings_kernel(
                self.model, intr[:, None, :], uv
            )
        self._stacked = (uv, valid, desc, bear)
        return self._stacked

    def match_stereo(self):
        """Stereo pairs with known extrinsics + epipolar check
        (sfm.cpp:1217-1272)."""
        t0, d0 = time.time(), self.device_seconds
        self.clear_tracks()
        with self._dev():
            # ONE jitted dispatch: running these ~30 tiny se3/essential ops
            # eagerly costs a compile + dispatch EACH, every run — they are
            # too cheap for the persistent compilation cache's 0.5 s
            # threshold
            T_0_1, E = jax.tree_util.tree_map(np.asarray, _stereo_geometry(
                jnp.asarray(self.calib.T_i_c[0]),
                jnp.asarray(self.calib.T_i_c[1]),
            ))
        num_matches = 0
        num_inliers = 0
        self.log(f"Matching {self.num_frames} stereo pairs...")
        # chunk-vmapped like match_all: one compiled computation per chunk of
        # stereo pairs (Hamming + ratio/cross-check + epipolar test) instead
        # of per-pair dispatches
        idx = {f: i for i, f in enumerate(self.fcids)}
        stereo = [
            (idx[(fid, 0)], idx[(fid, 1)], fid)
            for fid in range(self.num_frames)
            if (fid, 0) in idx and (fid, 1) in idx
        ]
        uv, valid, desc, bear = self._stack_features()
        # stereo keeps ALL matches (the reference stores the full match list
        # for the rectified pair, sfm.cpp:1217-1272) — cap at F, not at the
        # all-pairs budget
        MM = self.cfg.num_features_per_image
        cfg = self.cfg

        # feature stacks ride as jit ARGUMENTS (closure-captured jnp
        # arrays inline as HLO constants — program bloat that defeats the
        # compilation cache's cheap reload; see features/pair_matching.
        # _pair_chunk_impl), and ALL stereo chunks fold into one lax.map
        # mega-dispatch
        def one(desc, valid, bear, E, a, b):
            m12 = match.match_descriptors(
                desc[a], desc[b], valid[a], valid[b],
                cfg.feature_match_max_dist,
                cfg.feature_match_test_next_best,
            )
            pairs, pvalid, count = match.matches_to_pairs(m12, MM)
            b0 = bear[a][pairs[:, 0]]
            b1 = bear[b][pairs[:, 1]]
            inl = geometry.epipolar_inliers(
                b0, b1, E, cfg.epipolar_error_threshold
            ) & pvalid
            return pairs, count, inl

        @jax.jit
        def mega_fn(desc, valid, bear, E, i1g, i2g):
            return jax.lax.map(
                lambda t: jax.vmap(
                    lambda a, b: one(desc, valid, bear, E, a, b)
                )(*t),
                (i1g, i2g),
            )

        C = cfg.match_chunk_pairs
        chunks = [stereo[s: s + C] for s in range(0, len(stereo), C)]
        G = len(chunks)
        i1g = np.zeros((G, C), np.int32)
        i2g = np.ones((G, C), np.int32)
        for gi, chunk in enumerate(chunks):
            self._count("stereo_chunks")
            self._count("stereo_pairs", len(chunk))
            i1g[gi, : len(chunk)] = [a for a, _, _ in chunk]
            i2g[gi, : len(chunk)] = [b for _, b, _ in chunk]
        with self._dev():
            pairs_g, count_g, inl_g = jax.tree_util.tree_map(
                np.asarray,
                mega_fn(desc, valid, bear, jnp.asarray(E),
                        jnp.asarray(i1g), jnp.asarray(i2g)),
            )
        for gi, chunk in enumerate(chunks):
            pairs, count, inl = pairs_g[gi], count_g[gi], inl_g[gi]
            for ci, (_, _, fid) in enumerate(chunk):
                n = int(count[ci])
                all_pairs = pairs[ci][:n].astype(np.int32)
                inliers = pairs[ci][inl[ci]].astype(np.int32)
                self.matches[((fid, 0), (fid, 1))] = {
                    "T_i_j": T_0_1, "matches": all_pairs, "inliers": inliers,
                }
                num_matches += n
                num_inliers += len(inliers)
        self._stage_mark("match_stereo", t0, d0)
        self.log(
            f"Matched {self.num_frames} stereo pairs with {num_inliers} inlier "
            f"feature matches ({num_matches} total). New total of matched "
            f"image pairs is {len(self.matches)}."
        )

    def _pair_worklist(self):
        """All non-stereo pairs, (later, earlier) ordering (sfm.cpp:1284-1289)."""
        keys = self.fcids
        out = []
        for i in range(len(keys)):
            for j in range(i):
                if keys[i][0] != keys[j][0]:
                    out.append((i, j))
        return out

    def match_all(self):
        """Brute-force matching of all non-stereo pairs, chunk-vmapped on
        device (sfm.cpp:1275-1351)."""
        t0, d0 = time.time(), self.device_seconds
        self.clear_tracks()
        ids = self._pair_worklist()
        self.log(f"Brute-force matching {len(ids)} image pairs...")
        self._run_pair_matching(ids)
        self._stage_mark("match_all", t0, d0)
        self._report_pair_matching(ids)
        self._save_cache("matches")

    def _run_pair_matching(self, ids, mesh=None):
        from photometric_bundle_adjustment_tpu.features import (
            native_match,
            pair_matching,
        )

        cfg = self.cfg
        uv, valid, desc, bear = self._stack_features()
        C = cfg.match_chunk_pairs

        # CPU fast path: the native C++ Hamming matcher (all cores, same
        # semantics bit-for-bit) supplies the match lists; the device only
        # runs the batched RANSAC.  ~7x faster than XLA-on-CPU matching.
        use_native = (
            mesh is None
            and jax.default_backend() == "cpu"
            and native_match.available()
        )
        if use_native:
            pa = np.array([a for a, _ in ids], np.int32)
            pb = np.array([b for _, b in ids], np.int32)
            m12_all = native_match.match_pairs(
                np.asarray(desc), np.asarray(valid), pa, pb,
                cfg.feature_match_max_dist, cfg.feature_match_test_next_best,
            )
            pairs_all, pvalid_all, count_all = pair_matching.compact_matches_np(
                m12_all, cfg.max_matches_per_pair
            )
            rchunk = pair_matching.make_ransac_chunk(
                bear,
                ransac_thresh=cfg.relative_pose_ransac_thresh,
                ransac_min_inliers=cfg.relative_pose_ransac_min_inliers,
                ransac_hypotheses=cfg.ransac_hypotheses,
            )

            def run_chunk(i1, i2, s, e, pad):
                def padi(x, fill=0):
                    if not pad:
                        return jnp.asarray(x[s:e])
                    return jnp.asarray(np.concatenate(
                        [x[s:e], np.full((pad,) + x.shape[1:], fill, x.dtype)]
                    ))

                with self._dev():
                    T, inl, n_inl = rchunk(
                        jnp.asarray(i1), jnp.asarray(i2), padi(pairs_all),
                        padi(pvalid_all), padi(count_all), self._next_key(),
                    )
                    T, inl, n_inl = (np.asarray(T), np.asarray(inl),
                                     np.asarray(n_inl))
                return (np.asarray(pairs_all[s:e]),
                        np.asarray(count_all[s:e]), T, inl, n_inl)
        elif mesh is not None:
            chunk_fn = pair_matching.make_pair_matcher(
                desc, valid, bear,
                max_matches=cfg.max_matches_per_pair,
                match_max_dist=cfg.feature_match_max_dist,
                match_ratio=cfg.feature_match_test_next_best,
                ransac_thresh=cfg.relative_pose_ransac_thresh,
                ransac_min_inliers=cfg.relative_pose_ransac_min_inliers,
                ransac_hypotheses=cfg.ransac_hypotheses,
                mesh=mesh,
            )
        else:
            # accelerator path: fold chunks into fixed-G mega-dispatches
            # (lax.map over the vmapped chunk matcher) instead of one
            # dispatch round trip per chunk; results are bit-identical
            # because the same chunk function runs with the same per-chunk
            # key stream
            mega_fn = pair_matching.make_mega_pair_matcher(
                desc, valid, bear,
                max_matches=cfg.max_matches_per_pair,
                match_max_dist=cfg.feature_match_max_dist,
                match_ratio=cfg.feature_match_test_next_best,
                ransac_thresh=cfg.relative_pose_ransac_thresh,
                ransac_min_inliers=cfg.relative_pose_ransac_min_inliers,
                ransac_hypotheses=cfg.ransac_hypotheses,
            )

        def consume_chunk(chunk, pairs, count, T, inl):
            for ci, (a, b) in enumerate(chunk):
                n = int(count[ci])
                all_pairs = pairs[ci][: n].astype(np.int32)
                inliers = pairs[ci][inl[ci]].astype(np.int32)
                self.matches[(self.fcids[a], self.fcids[b])] = {
                    "T_i_j": T[ci], "matches": all_pairs, "inliers": inliers,
                }

        if not use_native and mesh is None:
            chunks = [ids[s: s + C] for s in range(0, len(ids), C)]
            for chunk in chunks:
                self._count("match_chunks")
                self._count("match_pairs", len(chunk))
            # per-chunk keys drawn in one batched split (chunk order)
            keys = self._next_keys(max(len(chunks), 1))
            done = 0
            while done < len(chunks):
                # two compiled group sizes: big groups + a small tail tier
                G = 128 if len(chunks) - done >= 128 else 16
                group = chunks[done: done + G]
                kg = keys[done: done + G]
                if len(group) < G:
                    kg = jnp.concatenate(
                        [kg, jnp.broadcast_to(
                            keys[done], (G - len(group),) + kg.shape[1:]
                        )]
                    )
                i1 = np.zeros((G, C), np.int32)
                i2 = np.ones((G, C), np.int32)
                for gi, chunk in enumerate(group):
                    i1[gi, : len(chunk)] = [a for a, _ in chunk]
                    i2[gi, : len(chunk)] = [b for _, b in chunk]
                self._count("match_mega_dispatches")
                with self._dev():
                    pairs, count, T, inl = jax.tree_util.tree_map(
                        np.asarray,
                        mega_fn(jnp.asarray(i1), jnp.asarray(i2), kg),
                    )
                for gi, chunk in enumerate(group):
                    consume_chunk(chunk, pairs[gi], count[gi], T[gi],
                                  inl[gi])
                done += len(group)
            return

        for s in range(0, len(ids), C):
            chunk = ids[s : s + C]
            self._count("match_chunks")
            self._count("match_pairs", len(chunk))
            pad = C - len(chunk)
            i1 = np.array([a for a, _ in chunk] + [0] * pad, np.int32)
            i2 = np.array([b for _, b in chunk] + [1] * pad, np.int32)
            if use_native:
                pairs, count, T, inl, n_inl = run_chunk(
                    i1, i2, s, s + len(chunk), pad
                )
            else:
                with self._dev():
                    pairs, pvalid, count, T, inl, n_inl = (
                        jax.tree_util.tree_map(
                            np.asarray,
                            chunk_fn(jnp.asarray(i1), jnp.asarray(i2),
                                     self._next_key()),
                        )
                    )
            consume_chunk(chunk, pairs, count, T, inl)

    def _report_pair_matching(self, ids):
        num_matches = num_inliers = num_success = 0
        for a, b in ids:
            md = self.matches[(self.fcids[a], self.fcids[b])]
            num_matches += len(md["matches"])
            num_inliers += len(md["inliers"])
            num_success += int(len(md["inliers"]) > 0)
        self.log(
            f"Successfully matched {num_success} out of {len(ids)} image pairs "
            f"with a total of {num_inliers} inlier feature matches "
            f"({num_matches} total). New total of matched image pairs is "
            f"{len(self.matches)}."
        )

    def match_bow(self):
        """BoW-candidate matching (sfm.cpp:1355-1452); needs a vocabulary."""
        from photometric_bundle_adjustment_tpu.features import bow

        if getattr(self, "bow_voc", None) is None:
            self.log(
                "Vocabulary not specified. Provide pipeline.bow_voc, or use "
                "match_all."
            )
            return
        t0, d0 = time.time(), self.device_seconds
        self.clear_tracks()
        db = bow.BowDatabase(self.bow_voc.num_words)
        idx_of = {f: i for i, f in enumerate(self.fcids)}
        ids = []
        for fcid in self.fcids:
            c = self.corners[fcid]
            v = self.bow_voc.transform(c["desc"][c["valid"]])
            res = db.query(v, self.cfg.num_bow_candidates)
            for other, _score in res:
                if other[0] != fcid[0]:
                    ids.append((idx_of[fcid], idx_of[other]))
            db.insert(fcid, v)
        self.log(f"Matching {len(ids)} image pairs using BoW...")
        self._run_pair_matching(ids)
        self._stage_mark("match_bow", t0, d0)
        self._report_pair_matching(ids)
        self._save_cache("matches")

    # ------------------------------------------------------------- stage 3-4

    def build_tracks(self):
        from photometric_bundle_adjustment_tpu.pipeline import native_tracks

        self.clear_tracks()
        inlier_matches = {
            k: v["inliers"] for k, v in self.matches.items() if len(v["inliers"])
        }
        # native (C++ union-find) fast path; falls back to pure Python
        self.tracks = native_tracks.build_tracks(
            inlier_matches, self.cfg.min_track_length
        )
        n_inl = sum(len(v) for v in inlier_matches.values())
        total_obs = sum(len(t) for t in self.tracks.values())
        avg = total_obs / max(len(self.tracks), 1)
        self.log(
            f"Built {len(self.tracks)} feature tracks from {n_inl} matches. "
            f"Average track length is {avg:.5g}."
        )

    def initialize_scene(self):
        """First stereo pair + triangulation (sfm.cpp:1543-1571,
        map_utils.h:204-227)."""
        self.clear_map()
        fcid0, fcid1 = (0, 0), (0, 1)
        self.cameras[fcid0] = np.array([0, 0, 0, 0, 0, 0, 1.0])
        self.cameras[fcid1] = np.asarray(self.calib.T_i_c[1], np.float64)
        self.add_landmarks_between(fcid0, fcid1)
        self.log(
            f"Initialized scene with {len(self.cameras)} cameras and "
            f"{len(self.landmarks)} landmarks."
        )
        self.stage = Stage.OPTIMIZE

    def _batch_triangulate(self, rows: list):
        """Triangulate (fcid0, fcid1, tid) rows in one bucketed kernel call
        with the parallax gate; returns (inv_depth (N,), ok (N,))."""
        uvf, off = self._uv_table()
        pose_tab, pose_of = self._pose_table()
        n = len(rows)
        uv0 = uvf[np.fromiter(
            (off[f0] + self.tracks[t][f0] for f0, _, t in rows), np.int64, n
        )]
        uv1 = uvf[np.fromiter(
            (off[f1] + self.tracks[t][f1] for _, f1, t in rows), np.int64, n
        )]
        intr = np.asarray(self.calib.intrinsics)
        i0 = np.fromiter((f0[1] for f0, _, _ in rows), np.int64, n)
        i1 = np.fromiter((f1[1] for _, f1, _ in rows), np.int64, n)
        T0 = pose_tab[np.fromiter((pose_of[f0] for f0, _, _ in rows),
                                  np.int64, n)]
        T1 = pose_tab[np.fromiter((pose_of[f1] for _, f1, _ in rows),
                                  np.int64, n)]
        N = len(rows)
        M = _bucket(N, 256)
        self._count("triangulate_calls")
        self._count(f"triangulate_rows_{M}")
        # parallax gate: rays must subtend a minimum angle at the point,
        # else the midpoint depth is unconstrained (see config note)
        min_cos = float(np.cos(np.deg2rad(self.cfg.min_triangulation_angle_deg)))
        from photometric_bundle_adjustment_tpu.utils import pack as pack_mod

        bufs, spec = pack_mod.pack_tree_bytes((
            _pad_rows(uv0, M), _pad_rows(uv1, M),
            _pad_rows(i0.astype(np.uint8)[:, None], M)[:, 0],
            _pad_rows(i1.astype(np.uint8)[:, None], M)[:, 0],
            intr, _pad_rows(T0, M), _pad_rows(T1, M),
        ))
        with self._dev():
            packed = np.asarray(_triangulate_rows_packed(
                self.model, jnp.asarray(bufs), min_cos, spec,
            ))
        return packed[:N, 0], packed[:N, 1] > 0.5

    def _add_triangulated(self, rows, inv_depth, ok) -> int:
        """First-passing-row-wins landmark insertion (pair order = the
        reference's sequential pair processing, sfm.cpp:1826-1880)."""
        n_new = 0
        for (f0, f1, t), rho, good in zip(rows, inv_depth, ok):
            if not good or t in self.landmarks:
                continue
            obs = {
                fcid: feat
                for fcid, feat in self.tracks[t].items()
                if fcid in self.cameras
            }
            self.landmarks[t] = Landmark(float(rho), obs)
            n_new += 1
        return n_new

    def _image_track_index(self):
        """Per-image track-id sets + track insertion ranks, rebuilt when
        the track dict changes (build, cache load, outlier pop).  Turns
        the O(images^2 x tracks) all-pairs shared-track scans of the
        landmark-growing stage (GetTracksInImages, tracks.h:175-197) into
        set intersections — the round-3 host profile showed those scans
        as the largest pure-Python cost of the incremental loop."""
        key = (id(self.tracks), len(self.tracks))
        if getattr(self, "_tix_key", None) != key:
            idx: dict = {}
            order: dict = {}
            for i, (tid, tr) in enumerate(self.tracks.items()):
                order[tid] = i
                for fcid in tr:
                    idx.setdefault(fcid, set()).add(tid)
            self._tix = idx
            self._tix_order = order
            self._tix_key = key
        return self._tix, self._tix_order

    def _shared_track_ids(self, fcid_a, fcid_b) -> list:
        """Track ids observed in both images, in track insertion order —
        exactly tracks_in_images({a, b}, tracks) but via the index."""
        idx, order = self._image_track_index()
        s = idx.get(fcid_a, set()) & idx.get(fcid_b, set())
        return sorted(s, key=order.__getitem__)

    def add_landmarks_between(self, fcid0, fcid1) -> int:
        """Triangulate shared, not-yet-landmark tracks between two mapped
        cameras (add_new_landmarks_between_cams, map_utils.h:121-195)."""
        shared = self._shared_track_ids(fcid0, fcid1)
        new_tids = [t for t in shared if t not in self.landmarks]
        if not new_tids:
            return 0
        rows = [(fcid0, fcid1, t) for t in new_tids]
        inv_depth, ok = self._batch_triangulate(rows)
        return self._add_triangulated(rows, inv_depth, ok)

    # -------------------------------------------------------- incremental map

    def compute_camera_candidate_set(self):
        """Two-tier candidate selection (sfm.cpp:1608-1704)."""
        num_tried = sum(c.tried for c in self.candidates)
        num_added = sum(c.camera_added for c in self.candidates)
        num_remaining = len(self.images) - len(self.cameras)
        previous_attempt_failed = (
            self.min_localization_inliers > 0 and num_tried > 0 and num_added == 0
        )
        self.candidates = []
        # wave-localization cache is only valid within one candidate round
        # (BA / outlier removal / new landmarks change the geometry)
        self._loc_cache = {}
        self.stage = Stage.DONE
        if num_remaining <= 0:
            self.log(
                f"Cannot select candidate set. All {len(self.cameras)} have "
                "already been added. That's it..."
            )
            return
        if not previous_attempt_failed:
            self.min_localization_inliers = (
                self.cfg.desired_localization_inlier_count
            )
            self.max_cameras_to_add = self.cfg.desired_inlier_max_cameras_to_add
            self._next_candidate_set()
        if not self.candidates:
            if (
                previous_attempt_failed
                and self.min_localization_inliers
                <= self.cfg.minimal_localization_inlier_count
            ):
                self.log(
                    "Previous candidate set with minimal shared track threshold "
                    f"{self.min_localization_inliers} didn't result in any "
                    f"added camera, so don't try again. There are "
                    f"{num_remaining} cameras left. That's it..."
                )
                return
            self.min_localization_inliers = (
                self.cfg.minimal_localization_inlier_count
            )
            self.max_cameras_to_add = self.cfg.minimal_inlier_max_cameras_to_add
            self._next_candidate_set()
            if not self.candidates:
                self.log(
                    "Did not find any camera candidates (shared track thresh: "
                    f"{self.min_localization_inliers}). There are "
                    f"{num_remaining} cameras left. That's it..."
                )
                return
        self.log(
            f"Selected {len(self.candidates)} camera candidates from "
            f"{num_remaining} remaining cameras (shared track thresh: "
            f"{self.min_localization_inliers})."
        )
        self.stage = Stage.ADD_CAMERAS

    def _next_candidate_set(self):
        idx, _ = self._image_track_index()
        # landmark insertion rank reproduces shared_tracks' iteration
        # order (GetSharedTracks, tracks.h:209-221) from the index
        lm_rank = {tid: i for i, tid in enumerate(self.landmarks)}
        lm_keys = self.landmarks.keys()
        cands = []
        for fcid in self.fcids:
            if fcid in self.cameras:
                continue
            shared = sorted(idx.get(fcid, set()) & lm_keys,
                            key=lm_rank.__getitem__)
            if len(shared) >= self.min_localization_inliers:
                cands.append(Candidate(fcid, shared))
        cands.sort(key=lambda c: -len(c.shared_tracks))
        self.candidates = cands

    def localize_camera(self, fcid, shared_track_ids):
        """PnP RANSAC + refinement (localize_camera, map_utils.h:242-302).

        Candidates are localized in batched WAVES (one vmapped dispatch for
        this candidate plus the next untried ones) and served from a
        per-round cache: within an ADD_CAMERAS round the landmark geometry
        the PnP consumes is fixed — this also matches the reference more
        closely than strictly sequential localization, whose ``Landmark.p``
        (common_types.h:188-219) does NOT move when observations are added
        mid-round, whereas our anchored representation could shift a
        landmark's anchor when a newly added camera sorts before it."""
        cache = getattr(self, "_loc_cache", None)
        if cache is None or fcid not in cache:
            self._localize_wave(fcid, shared_track_ids)
            cache = self._loc_cache
        T_w_c, inl = cache.pop(fcid)
        inlier_tids = [t for t, ok in zip(shared_track_ids, inl) if ok]
        return T_w_c, inlier_tids

    def _localize_wave(self, fcid, shared_track_ids, W: int = 16):
        """One batched localize dispatch for ``fcid`` and up to W-1 of the
        next untried candidates; results land in ``self._loc_cache``."""
        wave = [(fcid, list(shared_track_ids))]
        for c in self.candidates:
            if len(wave) >= W:
                break
            if c.fcid == fcid or c.tried or c.camera_added:
                continue
            wave.append((c.fcid, list(c.shared_tracks)))

        # anchor-side get_p inputs for every wave member, batched; the
        # world-point computation runs INSIDE the localize kernel (no
        # separate landmark-positions dispatch)
        all_tids: list = []
        spans = []
        for _, tids in wave:
            spans.append((len(all_tids), len(tids)))
            all_tids.extend(tids)
        uv_a, intr_a, T_a, rho_a = self._anchor_arrays(all_tids)

        intr_tab = np.asarray(self.calib.intrinsics)
        M = max(_bucket(len(tids), minimum=1024) for _, tids in wave)
        B = _bucket(len(wave), minimum=4)
        uv_b = np.zeros((B, M, 2), uv_a.dtype)
        uva_b = np.zeros((B, M, 2), uv_a.dtype)
        intra_b = np.zeros((B, M) + intr_a.shape[1:], intr_a.dtype)
        Ta_b = np.zeros((B, M, 7), T_a.dtype)
        Ta_b[..., 6] = 1.0  # identity quaternion for padding rows
        rho_b = np.ones((B, M), rho_a.dtype)
        val_b = np.zeros((B, M), bool)
        intr_b = np.zeros((B,) + intr_tab.shape[1:], intr_tab.dtype)
        for wi, ((f, tids), (s0, n)) in enumerate(zip(wave, spans)):
            uv = self.corners[f]["uv"][np.fromiter(
                (self.tracks[t][f] for t in tids), np.int64, n,
            )]
            uv_b[wi, :n] = uv
            uv_b[wi, n:] = uv[-1] if n else 0.0
            uva_b[wi, :n] = uv_a[s0: s0 + n]
            intra_b[wi, :n] = intr_a[s0: s0 + n]
            intra_b[wi, n:] = intr_a[s0] if n else 1.0
            Ta_b[wi, :n] = T_a[s0: s0 + n]
            rho_b[wi, :n] = rho_a[s0: s0 + n]
            val_b[wi, :n] = True
            intr_b[wi] = intr_tab[f[1]]
            self._count("localize_calls")
            self._count(f"localize_rows_{M}")
        self._count("localize_waves")

        from photometric_bundle_adjustment_tpu.utils import pack as pack_mod

        bufs, spec = pack_mod.pack_tree_bytes(
            (uv_b, intr_b, uva_b, intra_b, Ta_b, rho_b, val_b)
        )
        with self._dev():
            keys = self._next_keys(B)
            packed = np.asarray(_localize_batch_packed(
                self.model, jnp.asarray(bufs), keys,
                float(self.cfg.reprojection_error_pnp_inlier_threshold_pixel),
                int(self.cfg.pnp_hypotheses), spec,
            ))
        T_b = packed[:, :7]
        inl_b = packed[:, 7:] > 0.5
        if not hasattr(self, "_loc_cache") or self._loc_cache is None:
            self._loc_cache = {}
        for wi, ((f, tids), (s0, n)) in enumerate(zip(wave, spans)):
            self._loc_cache[f] = (T_b[wi], inl_b[wi, :n])

    def add_next_camera(self):
        """Try the next untried candidate (add_next_camera, sfm.cpp:1708-1822)."""
        candidate = None
        i = 0
        num_added = sum(c.camera_added for c in self.candidates)
        for idx, c in enumerate(self.candidates):
            if not c.camera_added and not c.tried:
                c.tried = True
                candidate = c
                i = idx
                break
        else:
            i = len(self.candidates)

        if candidate is None:
            self.log(
                f"No more candidates (out of {len(self.candidates)}) to try. "
                f"Total added {num_added}."
            )
        elif num_added < self.max_cameras_to_add:
            fcid = candidate.fcid
            T_w_c, inlier_tids = self.localize_camera(
                fcid, candidate.shared_tracks
            )
            if self.cfg.always_add_all_observations:
                inlier_tids = candidate.shared_tracks
            if len(inlier_tids) < self.min_localization_inliers:
                self.log(
                    f"Cannot add camera {fcid} ({i + 1} of "
                    f"{len(self.candidates)}) with {len(inlier_tids)} "
                    "localization inlier "
                    f"({len(candidate.shared_tracks) - len(inlier_tids)} "
                    "outlier ignored)."
                )
            else:
                self.cameras[fcid] = T_w_c
                candidate.camera_added = True
                num_added += 1
                inlier_set = set(inlier_tids)
                for tid in candidate.shared_tracks:
                    if tid in inlier_set:
                        self.landmarks[tid].add_obs(
                            fcid, self.tracks[tid][fcid]
                        )
                    else:
                        self.landmarks[tid].outlier_obs[fcid] = (
                            self.tracks[tid][fcid]
                        )
                self.log(
                    f"Camera {fcid} ({i + 1} of {len(self.candidates)}) added "
                    f"to map observing {len(inlier_tids)} landmarks "
                    f"({len(candidate.shared_tracks) - len(inlier_tids)} "
                    "outlier ignored)."
                )

        more_to_add = True
        if i + 1 >= len(self.candidates):
            more_to_add = False
        elif num_added >= self.max_cameras_to_add:
            self.log(
                f"Reached maximum number of {num_added} (out of "
                f"{len(self.candidates)}) cameras to add in one go."
            )
            more_to_add = False
        if not more_to_add:
            if any(c.camera_added for c in self.candidates):
                self.stage = Stage.ADD_LANDMARKS
            else:
                self.stage = Stage.COMPUTE_CANDIDATES

    def add_new_landmarks(self):
        """Triangulate new landmarks for ALL cameras added this round in
        one batched dispatch (sfm.cpp:1826-1880).

        Row lists are collected per added camera IN ORDER and concatenated;
        ``_add_triangulated``'s first-passing-row-wins insertion then
        reproduces the reference's sequential per-camera processing exactly
        (a track that an earlier camera's row triangulates is skipped for
        later cameras; one that fails stays available), while the device
        sees ONE bucketed triangulation instead of one per camera."""
        pend = [c for c in self.candidates
                if c.camera_added and not c.landmarks_added]
        if not pend:
            self.log("No more cameras for which to add landmarks.")
            self.stage = Stage.OPTIMIZE
            return
        per_cam = []
        for candidate in pend:
            candidate.landmarks_added = True
            fcid = candidate.fcid
            rows = []
            for fcid_existing in list(self.cameras):
                if fcid_existing == fcid:
                    continue
                shared = self._shared_track_ids(fcid_existing, fcid)
                rows.extend(
                    (fcid_existing, fcid, t)
                    for t in shared
                    if t not in self.landmarks
                )
            per_cam.append((fcid, rows))
        flat = [r for _, rows in per_cam for r in rows]
        if flat:
            inv_depth, ok = self._batch_triangulate(flat)
        base = 0
        for fcid, rows in per_cam:
            n_new = 0
            if rows:
                n_new = self._add_triangulated(
                    rows, inv_depth[base: base + len(rows)],
                    ok[base: base + len(rows)],
                )
                base += len(rows)
            self.log(f"Added {n_new} new landmarks for image {fcid}.")
        self.stage = Stage.OPTIMIZE

    # ------------------------------------------------------------------- BA

    def _build_ba_problem(self):
        cam_list = sorted(self.cameras)
        cam_index = {f: i for i, f in enumerate(cam_list)}
        lm_list = sorted(self.landmarks)
        lm_index = {t: i for i, t in enumerate(lm_list)}

        K = _bucket(len(cam_list), 4)
        L = _bucket(len(lm_list), 64)
        # High-water-mark padding: the incremental loop calls BA ~40 times
        # with growing (K, L, O); every new pow2 bucket combination is a
        # recompile, and a compile can cost more than all 20 LM
        # iterations it serves.  Never shrink, and on accelerators
        # pre-pad K to the dataset size (known upfront) so the camera
        # bucket is compiled ONCE; extra padded cameras are fixed/masked
        # and cost ~nothing at the fused build's dense shapes.
        if not hasattr(self, "_ba_hwm"):
            if jax.default_backend() != "cpu":
                k_floor = _bucket(len(self.fcids), 4)
            else:
                k_floor = K
            self._ba_hwm = [max(K, k_floor), L, 0]
        self._ba_hwm[0] = K = max(K, self._ba_hwm[0])
        self._ba_hwm[1] = L = max(L, self._ba_hwm[1])

        poses = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (K, 1))
        for f, i in cam_index.items():
            poses[i] = self.cameras[f]
        rho = np.full(L, 0.5)
        anchor_uv = np.zeros((L, 2))
        anchor_cam_idx = np.zeros(L, np.int32)
        anchor_intr = np.zeros(L, np.int32)
        for t, i in lm_index.items():
            lm = self.landmarks[t]
            a = lm.anchor()
            rho[i] = lm.inv_depth
            anchor_uv[i] = self.corners[a]["uv"][lm.obs[a]]
            anchor_cam_idx[i] = cam_index[a]
            anchor_intr[i] = a[1]

        uvf, off = self._uv_table()
        # vectorised obs-table assembly: per-landmark cached sorted-obs
        # arrays (Landmark.sorted_obs_arrays) concatenated once, camera
        # and image-offset lookups as searchsorted over encoded fcid keys
        # — replaces a 29k-row Python scan per solve (round-4 profile)
        keys_l, feats_l = [], []
        for t in lm_list:
            k_arr, f_arr = self.landmarks[t].sorted_obs_arrays()
            keys_l.append(k_arr[1:])   # skip anchor obs (first in order)
            feats_l.append(f_arr[1:])
        if keys_l:
            nobs = np.fromiter((len(k) for k in keys_l), np.int64,
                               len(keys_l))
            keys = np.concatenate(keys_l)
            feats = np.concatenate(feats_l)
            ol = np.repeat(np.arange(len(lm_list)), nobs)
        else:
            keys = feats = ol = np.zeros(0, np.int64)
        # the frame*16+cam fcid encoding must be collision-free for the
        # searchsorted lookups below (advisor round-4: nothing asserted it)
        assert all(c < 16 for _, c in self.fcids), \
            "fcid encoding frame*16+cam requires cam ids < 16"
        cam_keys = np.fromiter(
            (f * 16 + c for (f, c) in cam_list), np.int64, len(cam_list)
        )   # ascending: cam_list is sorted and the encoding is monotone
        oc = np.searchsorted(cam_keys, keys)
        # obs ⊆ cameras invariant: a landmark observation referencing an
        # fcid outside cam_list would silently yield a wrong camera index
        # here (the old dict lookup raised KeyError) — fail loudly instead
        assert oc.size == 0 or np.array_equal(
            cam_keys[np.minimum(oc, len(cam_keys) - 1)], keys
        ), "BA observation references a camera not in the map"
        img_keys = np.fromiter(
            (f * 16 + c for (f, c) in self.fcids), np.int64, len(self.fcids)
        )
        img_off = np.fromiter(
            (off[f] for f in self.fcids), np.int64, len(self.fcids)
        )
        oi = np.searchsorted(img_keys, keys)
        assert oi.size == 0 or np.array_equal(
            img_keys[np.minimum(oi, len(img_keys) - 1)], keys
        ), "BA observation references an image outside the dataset"
        uvti = img_off[oi] + feats
        it = keys % 16                  # cam id of the target image
        oa = anchor_cam_idx[ol]
        ir = anchor_intr[ol]
        uv_t = uvf[uvti] if len(uvti) else []
        uv_r = anchor_uv[ol] if len(ol) else []
        O = _bucket(max(len(oa), 1))
        self._ba_hwm[2] = O = max(O, self._ba_hwm[2])
        pad = O - len(oa)
        intr_tab = np.asarray(self.calib.intrinsics)

        def parr(x, shape, fill=0):
            arr = np.asarray(x)
            if pad:
                arr = np.concatenate([arr, np.full((pad,) + shape, fill, arr.dtype)])
            return arr

        valid = np.concatenate([np.ones(len(oa)), np.zeros(pad)])
        fixed = np.zeros(K, bool)
        for f in [(0, 0), (0, 1)]:  # gauge (sfm.cpp:1903)
            if f in cam_index:
                fixed[cam_index[f]] = True
        fixed[len(cam_list):] = True  # padding cameras held fixed
        lm_valid = np.arange(L) < len(lm_list)

        # everything stays HOST-side numpy: bundle_adjustment's densify
        # step reorders on the host, so uploading here would mean a
        # device->host fetch per array per solve; build_problem preserves
        # numpy inputs and the single upload
        # happens when the reordered problem enters the jitted solve
        problem = geometric_ba.build_problem(
            poses=np.asarray(poses),
            inv_depth=np.asarray(rho),
            anchor_cam=parr(oa, ()) if len(oa) else np.zeros(O, np.int32),
            target_cam=parr(oc, ()) if len(oc) else np.zeros(O, np.int32),
            landmark=parr(ol, ()) if len(ol) else np.zeros(O, np.int32),
            uv_target=(parr(np.asarray(uv_t).reshape(-1, 2), (2,))
                       if len(uv_t) else np.zeros((O, 2))),
            uv_ref=(parr(np.asarray(uv_r).reshape(-1, 2), (2,))
                    if len(uv_r) else np.zeros((O, 2))),
            intr_ref=intr_tab[parr(ir, ()) if len(ir) else np.zeros(O, int)],
            intr_target=intr_tab[parr(it, ()) if len(it) else np.zeros(O, int)],
            valid=valid,
            fixed_cams=fixed,
            lm_valid=lm_valid,
        )
        return problem, cam_list, lm_list

    def _projection_rows_arrays(self, cam_index, lm_index):
        """Row enumeration + index arrays for the outlier-pass
        reprojection, CHAINED onto the BA solve's dispatch: the row
        topology is identical before and after the solve (BA moves
        values, not observations), so the projection inputs can be
        shipped with the solve and evaluated against the solved state on
        device — the separate remove_outliers round trips disappear.
        Enumeration order matches compute_projections exactly."""
        rows = []
        for tid, lm in self.landmarks.items():
            for fcid, feat in lm.obs.items():
                rows.append((tid, fcid, feat, False))
            for fcid, feat in lm.outlier_obs.items():
                rows.append((tid, fcid, feat, True))
        if not rows:
            return None, None, 0
        n = len(rows)
        uvf, off = self._uv_table()
        uv_meas = uvf[np.fromiter(
            (off[r[1]] + r[2] for r in rows), np.int64, n)]
        cam_idx = np.fromiter((cam_index[r[1]] for r in rows), np.int64, n)
        lm_idx = np.fromiter((lm_index[r[0]] for r in rows), np.int64, n)
        anchor: dict = {}
        for r in rows:
            t = r[0]
            if t not in anchor:
                lm = self.landmarks[t]
                a = min(lm.obs)
                anchor[t] = (a[1], cam_index[a], off[a] + lm.obs[a])
        an_idx = np.fromiter((anchor[r[0]][1] for r in rows), np.int64, n)
        uv_a = uvf[np.fromiter((anchor[r[0]][2] for r in rows),
                               np.int64, n)]
        ia_idx = np.fromiter((anchor[r[0]][0] for r in rows), np.int64, n)
        it_idx = np.fromiter((r[1][1] for r in rows), np.int64, n)
        M = _bucket(n, 256)
        proj = dict(
            uv_a=_pad_rows(uv_a, M),
            ia_idx=_pad_rows(ia_idx.astype(np.uint8)[:, None], M)[:, 0],
            an_idx=_pad_rows(an_idx.astype(np.int32)[:, None], M)[:, 0],
            uv_meas=_pad_rows(uv_meas, M),
            it_idx=_pad_rows(it_idx.astype(np.uint8)[:, None], M)[:, 0],
            cam_idx=_pad_rows(cam_idx.astype(np.int32)[:, None], M)[:, 0],
            lm_idx=_pad_rows(lm_idx.astype(np.int32)[:, None], M)[:, 0],
            intr_tab=np.asarray(self.calib.intrinsics),
        )
        return rows, proj, M

    def _run_ba_solve(self, problem, cam_list, lm_list, cfg):
        """One BA solve; updates cameras/landmarks; returns a host-side
        BAResult.  On accelerators the (problem, plan) tree rides to the
        device as per-dtype packed buffers and results come back in ONE
        packed fetch (geometric_ba.bundle_adjustment_packed) instead of
        ~20 per-array transfers.  The outlier
        pass's reprojection rows ride the same dispatch and are stashed
        for the following remove_outliers stage."""
        if jax.default_backend() != "cpu":
            cam_index = {f: i for i, f in enumerate(cam_list)}
            lm_index = {t: i for i, t in enumerate(lm_list)}
            rows, proj, M = self._projection_rows_arrays(
                cam_index, lm_index
            )
            with self._dev():
                poses, rho, res, proj_out = (
                    geometric_ba.bundle_adjustment_packed(
                        problem, self.model, cfg, proj=proj
                    )
                )
            if rows is not None and proj_out is not None:
                self._proj_stash = (rows, proj_out[: len(rows)], M)
        else:
            with self._dev():
                solved, res = geometric_ba.bundle_adjustment(
                    problem, self.model, cfg
                )
                packed = np.asarray(_pack_ba_out(
                    solved.cam_states, solved.inv_depth,
                    res.cost, res.initial_cost, res.lam, res.iterations,
                ))
            nK7 = solved.cam_states.shape[0] * 7
            nL = solved.inv_depth.shape[0]
            poses = packed[:nK7].reshape(-1, 7)
            rho = packed[nK7: nK7 + nL]
            cost, icost, lam, iters = packed[nK7 + nL:]
            res = ba.BAResult(
                cost=float(cost), initial_cost=float(icost),
                iterations=int(iters), lam=float(lam),
            )
        for i, f in enumerate(cam_list):
            self.cameras[f] = poses[i]
        for i, t in enumerate(lm_list):
            self.landmarks[t].inv_depth = float(rho[i])
        return res

    def optimize(self):
        """Bundle adjustment stage (sfm.cpp:1883-1925)."""
        t0, d0 = time.time(), self.device_seconds
        num_obs = sum(len(l.obs) for l in self.landmarks.values())
        num_new = (
            len(self.cameras)
            if self.min_localization_inliers == 0
            else sum(c.camera_added for c in self.candidates)
        )
        self.log(
            f"Optimizing map with {len(self.cameras)} cameras ({num_new} new), "
            f"{len(self.landmarks)} points and {num_obs} observations."
        )
        self._count("ba_solves")
        problem, cam_list, lm_list = self._build_ba_problem()
        cfg = ba.BAConfig(
            max_iterations=20,
            huber_delta=self.cfg.reprojection_error_huber_pixel,
        )
        res = self._run_ba_solve(problem, cam_list, lm_list, cfg)
        if self.cfg.ba_optimize_intrinsics:
            # block-coordinate step on the shared per-physical-camera
            # intrinsics (the reference's optimize_intrinsics option,
            # map_utils.h:339-345: target-frame intrinsics blocks variable,
            # ref-frame intrinsics held constant), then re-polish poses
            self._refine_intrinsics()
            problem, cam_list, lm_list = self._build_ba_problem()
            res2 = self._run_ba_solve(problem, cam_list, lm_list, cfg)
            res = res2._replace(
                iterations=res.iterations + res2.iterations,
                initial_cost=res.initial_cost,
            )
        self._stage_mark("ba", t0, d0, accumulate=True)
        self.timings["ba_iters"] = self.timings.get("ba_iters", 0) + int(
            res.iterations
        )
        if self.cfg.ba_verbose >= 1:
            self.log(
                f"BA: cost {float(res.initial_cost):.6e} -> "
                f"{float(res.cost):.6e} in {int(res.iterations)} iterations "
                f"({time.time() - t0:.2f}s)"
            )
        if self.stage == Stage.OPTIMIZE:
            self.stage = Stage.REMOVE_OUTLIERS

    def _refine_intrinsics(self):
        """Refine the shared (num_cams, 8) intrinsics with poses and depths
        held fixed (batched analog of the reference's optimize_intrinsics
        BA option, map_utils.h:339-345: the anchor-frame unprojection uses
        the pre-solve intrinsics as constants, the target-frame projection
        is differentiated).  Updates ``self.calib.intrinsics`` in place and
        invalidates the cached bearings."""
        from photometric_bundle_adjustment_tpu.optim import lm as lm_mod

        rows = [
            (tid, fcid, feat)
            for tid, lm in self.landmarks.items()
            for fcid, feat in lm.obs.items()
        ]
        if not rows:
            return
        tids = [r[0] for r in rows]
        p_w = self.landmark_positions(tids)
        T = np.stack([np.asarray(self.cameras[r[1]]) for r in rows])
        uv_meas = np.stack([self.corners[r[1]]["uv"][r[2]] for r in rows])
        cam_ids = np.array([r[1][1] for r in rows])
        N = len(rows)
        M = _bucket(N, 256)
        p_w_j = jnp.asarray(_pad_rows(p_w, M))
        T_j = jnp.asarray(_pad_rows(T, M))
        uv_j = jnp.asarray(_pad_rows(uv_meas, M))
        cam_j = jnp.asarray(_pad_rows(cam_ids[:, None], M)[:, 0])
        w_j = jnp.asarray((np.arange(M) < N).astype(p_w_j.dtype))
        model = self.model
        delta = self.cfg.reprojection_error_huber_pixel

        p_c = se3.act(se3.inverse(T_j), p_w_j)  # fixed camera-frame points

        def residuals(intr):
            uv_proj = cam_models.project(model, intr[cam_j], p_c)
            return ((uv_j - uv_proj) * w_j[:, None]).reshape(-1)

        intr0 = jnp.asarray(np.asarray(self.calib.intrinsics, np.float64))
        n_cams, F = intr0.shape
        cfg = lm_mod.LMConfig(
            max_iterations=10, huber_delta=delta, block_size=2
        )
        intr_opt, res = lm_mod.lm_solve(
            residuals, intr0,
            lambda x, d: x + d.reshape(n_cams, F),
            n_cams * F, cfg,
        )
        self.calib.intrinsics = np.asarray(intr_opt)
        self._stacked = None  # bearings depend on intrinsics
        if self.cfg.ba_verbose >= 1:
            self.log(
                f"Intrinsics refinement: cost {float(res.initial_cost):.6e} "
                f"-> {float(res.cost):.6e} in {int(res.iterations)} iterations"
            )

    # ------------------------------------------------------------- outliers

    @property
    def image_projections(self) -> dict:
        """Per-image projection records {fcid: {"obs": [...],
        "outlier_obs": [...]}} for the overlay renderers
        (utils/visualize.py).  Materialised LAZILY from the arrays of the
        last ``compute_projections`` call: building ~29k per-row dicts on
        every outlier pass cost ~20 s host per full run (round-4
        profile) and only the visualizer reads them."""
        if self._image_projections is None:
            d: dict = {}
            if getattr(self, "_proj_data", None) is not None:
                rows, uv_proj, err, flags = self._proj_data
                for i, (tid, fcid, feat, is_outlier) in enumerate(rows):
                    rec = {
                        "fcid": fcid, "err": float(err[i]),
                        "flags": int(flags[i]), "uv_proj": uv_proj[i],
                    }
                    d.setdefault(fcid, {"obs": [], "outlier_obs": []})
                    key = "outlier_obs" if is_outlier else "obs"
                    d[fcid][key].append(rec)
            self._image_projections = d
        return self._image_projections

    @image_projections.setter
    def image_projections(self, v):
        self._image_projections = v
        self._proj_data = None

    def compute_projections(self):
        """Batched reprojection of every observation, with outlier flags
        (compute_projections + set_outlier_flags, sfm.cpp:1928-2008).

        Returns ``(rows, err, flags)`` arrays for the vectorised outlier
        policy; the per-image record dicts are built lazily (see
        ``image_projections``)."""
        self.image_projections = {}
        rows = []  # (tid, fcid, feat, is_outlier_obs)
        for tid, lm in self.landmarks.items():
            for fcid, feat in lm.obs.items():
                rows.append((tid, fcid, feat, False))
            for fcid, feat in lm.outlier_obs.items():
                rows.append((tid, fcid, feat, True))
        if not rows:
            return None

        # consume the projection block chained onto the last BA dispatch
        # when the row topology is unchanged (it always is on the
        # optimize -> remove_outliers edge; the full-list equality check
        # makes staleness impossible, not just unlikely)
        stash = getattr(self, "_proj_stash", None)
        self._proj_stash = None
        if stash is not None and stash[0] == rows:
            packed, M = stash[1], stash[2]
            self._count("project_calls")
            self._count(f"project_rows_{M}")
            return self._finish_projections(
                rows, packed[:, :2], packed[:, 2], packed[:, 3],
                packed[:, 4],
            )
        tids = [r[0] for r in rows]
        # anchor-side arrays (get_p inputs) ride into the FUSED projection
        # kernel — one dispatch instead of lm-positions + project per pass
        uv_a, intr_a, T_a, rho = self._anchor_arrays(tids)
        uvf, off = self._uv_table()
        pose_tab, pose_of = self._pose_table()
        n = len(rows)
        T = pose_tab[np.fromiter((pose_of[r[1]] for r in rows), np.int64, n)]
        uv_meas = uvf[np.fromiter((off[r[1]] + r[2] for r in rows),
                                  np.int64, n)]
        cam_ids = np.fromiter((r[1][1] for r in rows), np.int64, n)
        intr_tab = np.asarray(self.calib.intrinsics)
        # the anchor intr rows are also rows of the calib table: recover
        # their indices so both intrinsics arrays ride as uint8 per row
        ia_ids = np.fromiter(
            (min(self.landmarks[r[0]].obs)[1] for r in rows), np.int64, n
        )
        N = len(rows)
        M = _bucket(N, 256)
        self._count("project_calls")
        self._count(f"project_rows_{M}")
        from photometric_bundle_adjustment_tpu.utils import pack as pack_mod

        bufs, spec = pack_mod.pack_tree_bytes((
            _pad_rows(uv_a, M),
            _pad_rows(ia_ids.astype(np.uint8)[:, None], M)[:, 0],
            _pad_rows(T_a, M),
            _pad_rows(rho[:, None], M)[:, 0],
            _pad_rows(uv_meas, M),
            _pad_rows(cam_ids.astype(np.uint8)[:, None], M)[:, 0],
            _pad_rows(T, M), intr_tab,
        ))
        with self._dev():
            packed = np.asarray(_project_obs_packed(
                self.model, jnp.asarray(bufs), spec,
            ))
        uv_proj, err, dist, zc = (packed[:N, :2], packed[:N, 2],
                                  packed[:N, 3], packed[:N, 4])
        return self._finish_projections(rows, uv_proj, err, dist, zc)

    def _finish_projections(self, rows, uv_proj, err, dist, zc):
        """Outlier flag assignment (set_outlier_flags, sfm.cpp:1974-2008)
        from the projected arrays, shared by the standalone and the
        BA-chained projection paths."""
        cfg = self.cfg
        flags = np.zeros(len(rows), np.int32)
        flags |= np.where(
            err > cfg.reprojection_error_outlier_threshold_huge_pixel,
            OUTLIER_REPROJECTION_HUGE, 0,
        )
        flags |= np.where(
            err > cfg.reprojection_error_outlier_threshold_normal_pixel,
            OUTLIER_REPROJECTION_NORMAL, 0,
        )
        flags |= np.where(
            dist < cfg.camera_center_distance_outlier_threshold_meter,
            OUTLIER_CAMERA_DISTANCE, 0,
        )
        flags |= np.where(
            zc < cfg.z_coordinate_outlier_threshold_meter,
            OUTLIER_Z_COORDINATE, 0,
        )

        self._proj_data = (rows, uv_proj, err, flags)
        self._image_projections = None
        return rows, err, flags

    def remove_outlier_landmarks(self):
        """Outlier taxonomy + removal policy (sfm.cpp:2028-2131).

        Vectorised re-statement of the reference's per-track scan loop:
        each track's (non-outlier) observation records are scanned in
        insertion order; the first record that triggers removal decides
        the counter (per-record priority huge > normal > distance > z,
        with normal triggering removal only when no severe flag exists
        anywhere).  Implemented as numpy segment reductions over the
        contiguous per-landmark row groups of ``compute_projections`` —
        the per-row dict scan cost ~20 s host per full run (round-4
        profile); counters and log strings are bit-identical to the
        scalar loop (the reference-matching regression oracle)."""
        res = self.compute_projections()
        if res is None:
            removed, n_huge, n_normal, n_dist, n_z, any_severe = (
                [], 0, 0, 0, 0, False
            )
        else:
            rows, err, flags = res
            n = len(rows)
            keep = ~np.fromiter((r[3] for r in rows), bool, n)
            (removed, n_huge, n_normal, n_dist, n_z, any_severe) = (
                outlier_policy(
                    np.fromiter((r[0] for r in rows), np.int64, n)[keep],
                    flags[keep],
                )
            )
        for tid in removed:
            if tid in self.tracks:
                self.outlier_tracks[tid] = self.tracks.pop(tid)
            self.landmarks.pop(tid, None)

        num_total = (
            (n_huge + n_dist + n_z) if any_severe else n_normal
        )
        if num_total > 0:
            if any_severe:
                self.log(
                    f"{num_total} outliers removed ({n_huge} for huge repr. "
                    f"error ({n_normal} not removed), {n_dist} too close to "
                    f"camera center, {n_z} too small z)."
                )
            else:
                self.log(
                    f"{num_total} outliers removed for too large repr. error."
                )
        if self.stage == Stage.REMOVE_OUTLIERS:
            self.stage = (
                Stage.OPTIMIZE if num_total > 0 else Stage.COMPUTE_CANDIDATES
            )

    # ----------------------------------------------------------- state machine

    def _timed(self, name, fn, *args, **kwargs):
        t0, d0 = time.time(), self.device_seconds
        out = fn(*args, **kwargs)
        self._stage_mark(name, t0, d0, accumulate=True)
        return out

    def _stage_mark(self, name, t0, d0, accumulate=False):
        """Record a stage's wall and device-block seconds (host = wall -
        device); ``accumulate`` adds to any prior total for the stage."""
        dt = time.time() - t0
        dd = self.device_seconds - d0
        if accumulate:
            self.timings[name] = self.timings.get(name, 0.0) + dt
            self.timings_dev[name] = self.timings_dev.get(name, 0.0) + dd
        else:
            self.timings[name] = dt
            self.timings_dev[name] = dd

    def _maybe_reload_params(self):
        """Headless analog of the reference's live-tunable Pangolin
        parameter panel (~30 GUI vars, sfm.cpp:197-261): if the watched
        JSON file changed since the last step, matching SfmConfig fields
        are updated in place and take effect from the next stage on.
        (Shape-sizing knobs such as max_matches_per_pair apply to kernels
        built after the change.)"""
        import dataclasses
        import json
        import os

        path = self.params_file
        if not path or not os.path.exists(path):
            return
        # (mtime, size) stamp: a rewrite landing within the filesystem's
        # timestamp granularity is still picked up when the length changes.
        # Writers should replace the file atomically (write temp + rename);
        # a torn read is caught by the JSON-error retry path below.
        st = os.stat(path)
        stamp = (st.st_mtime, st.st_size)
        if stamp == self._params_mtime:
            return
        self._params_mtime = stamp
        try:
            with open(path) as f:
                new = json.load(f)
        except (OSError, ValueError) as e:  # half-written file: retry later
            self.log(f"params-file {path}: not reloaded ({e})")
            self._params_mtime = None
            return
        known = {f.name for f in dataclasses.fields(self.cfg)}
        changed = []
        for k, v in new.items():
            if k not in known:
                self.log(f"params-file: unknown parameter {k!r} ignored")
                continue
            old = getattr(self.cfg, k)
            if isinstance(old, bool):
                # type(old)(v) would coerce the string "false" to True;
                # bool fields accept only JSON true/false
                if not isinstance(v, bool):
                    self.log(
                        f"params-file: non-boolean value for {k!r} "
                        f"ignored: {v!r}"
                    )
                    continue
            else:
                try:
                    v = type(old)(v)
                except (TypeError, ValueError):
                    self.log(
                        f"params-file: bad value for {k!r} ignored: {v!r}"
                    )
                    continue
            if v != old:
                setattr(self.cfg, k, v)
                changed.append(f"{k}: {old} -> {v}")
        if changed:
            self.log("Parameters updated: " + "; ".join(changed))

    def next_step(self) -> bool:
        """One pipeline step; returns False when done (next_step,
        sfm.cpp:1117-1167)."""
        self._maybe_reload_params()
        if not self.corners:
            if not self._load_cache("corners"):
                self.detect_keypoints()
            return True
        if not self.matches:
            if not self._load_cache("matches"):
                self.match_stereo()
                if self.cfg.use_match_bow:
                    self.match_bow()
                else:
                    self.match_all()
            return True
        if not self.tracks:
            self._timed("build_tracks", self.build_tracks)
            return True
        if not self.cameras:
            self._timed("init_scene", self.initialize_scene)
            return True
        if self.stage == Stage.COMPUTE_CANDIDATES:
            self._timed("candidates", self.compute_camera_candidate_set)
            return True
        if self.stage == Stage.ADD_CAMERAS:
            self._timed("add_cameras", self.add_next_camera)
            return True
        if self.stage == Stage.ADD_LANDMARKS:
            self._timed("add_landmarks", self.add_new_landmarks)
            return True
        if self.stage == Stage.OPTIMIZE:
            self.optimize()
            return True
        if self.stage == Stage.REMOVE_OUTLIERS:
            self._timed("remove_outliers", self.remove_outlier_landmarks)
            return True
        if self.counters:
            self.log(
                "Kernel invocations: "
                + " ".join(f"{k}={v}" for k, v in sorted(self.counters.items()))
            )
        self.log(self.summary())
        return False

    def run(self) -> None:
        while self.next_step():
            pass

    def load_map(self, m: dict) -> None:
        """Adopt a saved map (the pickle apps.sfm / apps.pba write):
        cameras, tracks and landmarks.  Observations reference feature
        ids, so ``corners`` must come from the same detection."""
        self.cameras = dict(m["cameras"])
        self.tracks = dict(m.get("tracks", {}))
        self.landmarks = {
            t: Landmark(d["inv_depth"], dict(d["obs"]),
                        dict(d.get("outlier_obs", {})))
            if isinstance(d, dict) else d
            for t, d in m["landmarks"].items()
        }

    def summary(self) -> str:
        num_obs = sum(len(l.obs) for l in self.landmarks.values())
        num_outlier_obs = sum(
            len(l.outlier_obs) for l in self.landmarks.values()
        )
        return (
            f"The map has {len(self.cameras)} cameras and "
            f"{len(self.landmarks)} landmarks with {num_obs} observations. "
            f"{len(self.outlier_tracks)} landmarks were removed as outliers "
            f"and {num_outlier_obs} observations were marked as outliers."
        )

    # ----------------------------------------------------------------- caches

    def _cache_path(self, name):
        import os

        if self.cache_dir is None:
            return None
        return os.path.join(self.cache_dir, f"{name}.pkl")

    def _save_cache(self, name):
        import os

        path = self._cache_path(name)
        if path is None:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = self.corners if name == "corners" else self.matches
        with open(path, "wb") as f:
            pickle.dump({"n_images": len(self.images), "data": data}, f)
        self.log(f"Saved {name} as {path}")

    def _load_cache(self, name) -> bool:
        import os

        path = self._cache_path(name)
        if path is None or not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if blob["n_images"] != len(self.images):
            self.log(
                f"Ignoring cached {name} from {path} (contains {name} for "
                f"{blob['n_images']} images, but we have now loaded "
                f"{len(self.images)} images)."
            )
            return False
        if name == "corners":
            self.corners = blob["data"]
        else:
            self.matches = blob["data"]
        self.log(f"Loaded cached {name} from {path}")
        return True

    # ------------------------------------------------------------------ clears

    def clear_keypoints(self):
        self.corners = {}
        self._stacked = None
        self.clear_matches()

    def clear_matches(self):
        self.matches = {}
        self.clear_tracks()

    def clear_tracks(self):
        self.tracks = {}
        self.outlier_tracks = {}
        self.clear_map()

    def clear_map(self):
        self.cameras = {}
        self.landmarks = {}
        self.candidates = []
        self.stage = Stage.COMPUTE_CANDIDATES
        self.min_localization_inliers = 0
        self.max_cameras_to_add = 0
        self.image_projections = {}
