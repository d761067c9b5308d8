"""Photometric refinement of a geometric SfM map (the pba2 capability,
BASELINE config #4): take the geometric map (poses + anchored inverse
depths) as seed, build the direct intensity-patch problem over the real
images, and run the photometric Schur-LM solver.

Mirrors the structure the reference's pba2 branch adds on top of main
(SURVEY §0): same anchor-frame inverse-depth parameterisation, residuals
switch from 2-pixel reprojection to 8-pixel intensity patches with affine
brightness per (frame, cam) image.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu.optim import ba, fused
from photometric_bundle_adjustment_tpu.utils.shapes import bucket as _bucket



def build_photometric_problem(pipe, dtype=jnp.float32):
    """Construct (problem, images_flat, H, W, cam_list, lm_list) from a
    finished SfmPipeline (or any object with .cameras/.landmarks/.corners/
    .images/.calib)."""
    cam_list = sorted(pipe.cameras)
    cam_index = {f: i for i, f in enumerate(cam_list)}
    lm_list = sorted(pipe.landmarks)

    # image stack: one image per mapped camera, index == camera index
    img0 = next(iter(pipe.images.values()))
    H, W = img0.shape
    K = _bucket(len(cam_list), 4)
    images = np.zeros((K, H, W), np.float32)
    for f, i in cam_index.items():
        images[i] = pipe.images[f].astype(np.float32)
    images_flat = jnp.asarray(images.reshape(-1))

    L = _bucket(len(lm_list), 64)
    rho = np.full(L, 0.5, np.float64)
    anchor_uv = np.zeros((L, 2))
    anchor_cam_idx = np.zeros(L, np.int32)
    anchor_intr = np.zeros(L, np.int32)
    lm_index = {t: i for i, t in enumerate(lm_list)}
    for t, i in lm_index.items():
        lm = pipe.landmarks[t]
        a = lm.anchor()
        rho[i] = lm.inv_depth
        anchor_uv[i] = pipe.corners[a]["uv"][lm.obs[a]]
        anchor_cam_idx[i] = cam_index[a]
        anchor_intr[i] = a[1]

    ref_patch = pba.extract_ref_patches(
        images_flat,
        jnp.asarray(anchor_cam_idx),
        jnp.asarray(anchor_uv, dtype),
        H, W,
    )

    oa, oc, ol, it_ = [], [], [], []
    for t, i in lm_index.items():
        lm = pipe.landmarks[t]
        for fcid, _feat in sorted(lm.obs.items())[1:]:
            oa.append(anchor_cam_idx[i])
            oc.append(cam_index[fcid])
            ol.append(i)
            it_.append(fcid[1])
    O = _bucket(max(len(oa), 1))
    pad = O - len(oa)

    def parr(x):
        return np.concatenate([np.asarray(x, np.int32), np.zeros(pad, np.int32)])

    intr_tab = np.asarray(pipe.calib.intrinsics)
    obs_l = parr(ol)
    valid = np.concatenate([np.ones(len(oa)), np.zeros(pad)])
    fixed = np.zeros(K, bool)
    for f in [(0, 0), (0, 1)]:
        if f in cam_index:
            fixed[cam_index[f]] = True
    fixed[len(cam_list):] = True
    lm_valid = np.arange(L) < len(lm_list)

    problem = pba.build_problem(
        poses=jnp.asarray(
            np.concatenate(
                [np.stack([pipe.cameras[f] for f in cam_list]),
                 np.tile([0, 0, 0, 0, 0, 0, 1.0], (K - len(cam_list), 1))]
            ), dtype,
        ),
        affine=jnp.zeros((K, 2), dtype),
        inv_depth=jnp.asarray(rho, dtype),
        anchor_cam=parr(oa),
        target_cam=parr(oc),
        landmark=obs_l,
        uv_ref=jnp.asarray(anchor_uv, dtype)[obs_l],
        ref_patch=ref_patch.astype(dtype)[obs_l],
        target_img=parr(oc),  # image index == camera index
        intr_ref=jnp.asarray(intr_tab, dtype)[
            parr(anchor_intr[np.asarray(ol, np.int32)] if ol else [])
        ],
        intr_target=jnp.asarray(intr_tab, dtype)[parr(it_)],
        valid=valid,
        fixed_cams=fixed,
        lm_valid=lm_valid,
    )
    return problem, images_flat, H, W, cam_list, lm_list


def refine_photometric_distributed(
    pipe,
    n_devices: int = 8,
    max_iterations: int = 20,
    huber_delta: float = 9.0,
    compare_single: bool = True,
    camera_partition: bool = False,
    log=print,
):
    """Full-resolution photometric BA of the REAL map on an n_devices
    mesh: landmark-sharded shard_map solve (parallel/dist_fused.py), the
    distributed analog of the reference's TBB/Ceres-threads parallelism
    (src/sfm.cpp:1294-1319, map_utils.h:381).

    Real incremental maps are heavy-tailed in observations per landmark
    (EuRoC V1: max ~96 vs ~5 mean) — unlike the synthetic problems the
    distributed paths were previously exercised on.
    The ragged chunk-plan layout handles the tail without densification.

    With ``compare_single``, also runs the single-device fused solve on
    the same problem and logs the cost/pose agreement.  Returns
    ``(BAResult, parity: dict | None)`` and writes the DISTRIBUTED
    solution back into ``pipe``.
    """
    from photometric_bundle_adjustment_tpu.parallel import dist_fused
    from photometric_bundle_adjustment_tpu.parallel import mesh as mesh_mod

    t0 = time.time()
    problem, images_flat, H, W, cam_list, lm_list = build_photometric_problem(
        pipe
    )
    model = pipe.calib.cam_types[0] if pipe.calib.cam_types else "ds"
    cfg = ba.BAConfig(
        max_iterations=max_iterations, huber_delta=huber_delta,
        function_tolerance=1e-8,
    )
    res_fn = pba.make_residual_fn(model, images_flat, H, W)
    rj_fn = pba.make_rj_fn(model, images_flat, H, W)

    mesh = mesh_mod.make_mesh(n_devices)
    sharded = dist_fused.prepare(problem, mesh)
    dsolve = dist_fused.make_distributed_fused_solver(
        res_fn, pba.cam_retract, 8, mesh, rj_fn=rj_fn,
        camera_partition=camera_partition,
    )
    p_dist, res = dsolve(sharded, cfg)
    log(
        f"  distributed pba ({n_devices} devices, "
        f"{'partitioned PCG' if camera_partition else 'replicated'}): cost "
        f"{float(res.initial_cost):.6e} -> {float(res.cost):.6e} "
        f"({int(res.iterations)} it, {time.time() - t0:.1f}s)"
    )

    parity = None
    if compare_single:
        t1 = time.time()
        plan = fused.plan_for_problem(problem)
        solve = pba.make_fused_solver(model, images_flat, H, W)
        p_s, r_s = solve(problem, plan, cfg)
        pose_d = np.abs(
            np.asarray(p_dist.cam_states.pose)
            - np.asarray(p_s.cam_states.pose)
        ).max()
        cost_rel = abs(float(res.cost) - float(r_s.cost)) / max(
            float(r_s.cost), 1e-9
        )
        parity = {
            "cost_dist": float(res.cost), "cost_single": float(r_s.cost),
            "cost_rel": cost_rel, "pose_maxdiff": float(pose_d),
            "iters_dist": int(res.iterations),
            "iters_single": int(r_s.iterations),
        }
        log(
            f"  single-device check: cost {float(r_s.cost):.6e} "
            f"(rel diff {cost_rel:.2e}), pose max|d| {pose_d:.2e} "
            f"({time.time() - t1:.1f}s)"
        )

    # write the distributed solution back (landmark rows are permuted into
    # padded shard-contiguous order; lm_global_index maps them home)
    poses = np.asarray(p_dist.cam_states.pose, np.float64)
    rho_pad = np.asarray(p_dist.inv_depth, np.float64)
    gidx = sharded.lm_global_index
    for i, f in enumerate(cam_list):
        pipe.cameras[f] = poses[i]
    for i, t in enumerate(lm_list):
        r = float(rho_pad[gidx[i]])
        if r > 1e-6:
            pipe.landmarks[t].inv_depth = r
    pipe.photometric_affine = {
        f: np.asarray(p_dist.cam_states.affine[i])
        for i, f in enumerate(cam_list)
    }
    return res, parity


def level_problem(problem, pyramid, level: int):
    """``problem`` (full resolution) moved to pyramid ``level``: scaled
    intrinsics and anchor pixels, reference patches re-extracted from that
    level's images.  Returns ``(problem_l, images_flat_l, H_l, W_l)``."""
    imgs_l, H_l, W_l = pyramid[level]
    flat_l = imgs_l.reshape(-1)
    prob_l = pba.scale_problem_to_level(problem, level)
    aux = prob_l.obs.aux
    patch = pba.extract_ref_patches(
        flat_l, prob_l.obs.anchor_cam, aux.uv_ref, H_l, W_l
    )
    prob_l = prob_l._replace(
        obs=prob_l.obs._replace(aux=aux._replace(ref_patch=patch))
    )
    return prob_l, flat_l, H_l, W_l


def refine_photometric(
    pipe,
    max_iterations: int = 20,
    huber_delta: float = 9.0,
    levels: int = 3,
    log=print,
):
    """Run coarse-to-fine photometric BA seeded from the geometric map;
    writes refined poses/depths back into the pipeline, and each pyramid
    level's ``(level, initial_cost, cost, iterations)`` into
    ``pipe.photometric_levels``.  Returns the final (full-resolution)
    BAResult."""
    t0 = time.time()
    problem, images_flat, H, W, cam_list, lm_list = build_photometric_problem(
        pipe
    )
    model = pipe.calib.cam_types[0] if pipe.calib.cam_types else "ds"
    cfg = ba.BAConfig(
        max_iterations=max_iterations, huber_delta=huber_delta,
        function_tolerance=1e-8,
    )

    pyramid = pba.build_pyramid(images_flat.reshape(-1, H, W), levels)
    solved, res = problem, None
    state = problem
    pipe.photometric_levels = []
    for level in range(levels - 1, -1, -1):
        prob_l, flat_l, H_l, W_l = level_problem(state, pyramid, level)
        plan = fused.plan_for_problem(prob_l)
        solve = pba.make_fused_solver(model, flat_l, H_l, W_l)
        solved_l, res = solve(prob_l, plan, cfg)
        if level == 0:
            solved = solved_l
        # carry optimised state (poses/affine/depths) to the finer level
        state = state._replace(
            cam_states=solved_l.cam_states, inv_depth=solved_l.inv_depth
        )
        pipe.photometric_levels.append(
            (level, float(res.initial_cost), float(res.cost),
             int(res.iterations))
        )
        log(
            f"  pba level {level} ({W_l}x{H_l}): cost "
            f"{float(res.initial_cost):.4e} -> {float(res.cost):.4e} "
            f"({int(res.iterations)} it)"
        )
    poses = np.asarray(solved.cam_states.pose, np.float64)
    rho = np.asarray(solved.inv_depth, np.float64)
    for i, f in enumerate(cam_list):
        pipe.cameras[f] = poses[i]
    for i, t in enumerate(lm_list):
        if rho[i] > 1e-6:  # keep depths sane
            pipe.landmarks[t].inv_depth = float(rho[i])
    pipe.photometric_affine = {
        f: np.asarray(solved.cam_states.affine[i])
        for i, f in enumerate(cam_list)
    }
    n_obs = int(np.sum(np.asarray(problem.obs.valid)))
    log(
        f"Photometric BA over {len(cam_list)} cameras, {len(lm_list)} "
        f"landmarks, {n_obs} patch observations: cost "
        f"{float(res.initial_cost):.6e} -> {float(res.cost):.6e} in "
        f"{int(res.iterations)} iterations ({time.time() - t0:.2f}s)"
    )
    return res
