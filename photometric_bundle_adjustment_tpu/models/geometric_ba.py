"""Geometric (reprojection) bundle adjustment with anchored inverse-depth
landmarks.

The residual is the batched analog of
``BundleAdjustmentReprojectionCostFunctor`` (reprojection.h:74-118):

    r = p_2d - pi_2( T_w_c2^-1 * T_w_c1 * ( pi_1^-1(p_2d_ref) / rho ) )

where camera 1 is the landmark's **anchor** (first observation; the anchor
observation itself contributes no residual, map_utils.h:351-355), the anchor
intrinsics are held constant (map_utils.h:339-345 keeps ref-frame intrinsics
fixed), and rho is the scalar inverse depth (common_types.h:188-219).

Camera blocks are SE3 poses with right-plus retraction; gauge is fixed by
masking the first stereo pair (sfm.cpp:1903).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from photometric_bundle_adjustment_tpu.core import cameras, se3
from photometric_bundle_adjustment_tpu.optim import ba


class GeometricObs(NamedTuple):
    """aux pytree entries for one observation (leading dim O when batched)."""

    uv_target: jax.Array  # (2,) measured pixel in the target image
    uv_ref: jax.Array     # (2,) anchor pixel of the landmark
    intr_ref: jax.Array   # (8,) anchor camera intrinsics (held constant)
    intr_target: jax.Array  # (8,) target camera intrinsics


def make_residual_fn(model: str):
    """Residual for a single observation; ``cam_state`` is a pose (7,).

    The warp is evaluated in RAY form,

        q = R_c^T R_a d  +  rho * R_c^T (t_a - t_c)   (= rho * p_c),

    and projected directly — every camera model here is scale-invariant
    (pi(s p) = pi(p) for s > 0), so this equals the reference's
    pi(T_c^-1 T_a (d / rho)) exactly while staying numerically sound as
    rho -> 0: the d/rho form pushes ~1/rho-magnitude intermediates
    through f32 autodiff, and near-infinity landmarks (rho ~ 1e-5 appear
    in real EuRoC maps) produced garbage inverse-depth Jacobians in f32
    (catastrophic cancellation — observed J_rho snapping to whole
    numbers), stalling the pipeline's LM solves.
    """

    def residual(pose_a: jax.Array, pose_c: jax.Array, rho: jax.Array, aux):
        d = cameras.unproject_unit(model, aux.intr_ref, aux.uv_ref)
        # quaternion rotations, not 3x3 matrices: per-observation matrix
        # construction under the 13-tangent jacfwd lowers to tiny batched
        # matmuls, while quat_rotate stays elementwise
        qc_inv = se3.quat_conj(se3.rotation(pose_c))
        t_rel = se3.translation(pose_a) - se3.translation(pose_c)
        q = se3.quat_rotate(
            qc_inv, se3.quat_rotate(se3.rotation(pose_a), d)
        ) + rho * se3.quat_rotate(qc_inv, t_rel)
        return aux.uv_target - cameras.project(model, aux.intr_target, q)

    return residual


def cam_retract(pose: jax.Array, delta: jax.Array) -> jax.Array:
    return se3.right_plus(pose, delta)


def make_rj_fn(model: str):
    """Closed-form residual + Jacobian for one observation.

    Chain rule through the RAY-form warp (see make_residual_fn)
    q = M d + rho u  with  M = R_c^T R_a,  u = R_c^T (t_a - t_c),
    right-plus tangents in Sophus order [trans, rot]:

      dq/d(dt_a)  =  rho M
      dq/d(dphi_a)= -M [d]_x
      dq/d(dt_c)  = -rho I
      dq/d(dphi_c)=  [q]_x
      dq/d(rho)   =  u

    (q = rho p_c, so these are exactly rho times the p_c-form blocks and
    yield the identical Jacobian through the scale-invariant projection —
    but with no 1/rho anywhere, stable for near-infinity landmarks.)
    dr/dq = -dpi/dq (projection Jacobian, forward-mode through the 3-dim
    projection only).  Replaces the generic 13-pass jacfwd.
    """

    def rj(pose_a: jax.Array, pose_c: jax.Array, rho: jax.Array, aux):
        dtype = rho.dtype
        d = cameras.unproject_unit(model, aux.intr_ref, aux.uv_ref)
        Ra = se3.quat_to_matrix(se3.rotation(pose_a))
        Rc = se3.quat_to_matrix(se3.rotation(pose_c))
        t_a = se3.translation(pose_a)
        t_c = se3.translation(pose_c)
        M = Rc.T @ Ra
        u = Rc.T @ (t_a - t_c)
        q = M @ d + rho * u

        def pi(p):
            return cameras.project(model, aux.intr_target, p)

        uv_hat, Jq = pi(q), jax.jacfwd(pi)(q)    # (2,), (2, 3)
        r = aux.uv_target - uv_hat

        eye = jnp.eye(3, dtype=dtype)
        dq = jnp.concatenate(
            [
                rho * M,                            # d t_a
                -M @ se3.hat_so3(d),                # d phi_a
                -rho * eye,                         # d t_c
                se3.hat_so3(q),                     # d phi_c
                u[:, None],                         # d rho
            ],
            axis=1,
        )                                           # (3, 13)
        J = -Jq @ dq                                # (2, 13)
        return r, J

    return rj


def _use_manual_jacobians() -> bool:
    """Backend-adaptive default: the closed-form Jacobians are ~4x faster
    than jacfwd on CPU; accelerators take the fused forward-mode graph,
    which does not materialise per-observation (3, 13) chain blocks in
    device memory."""
    return jax.default_backend() == "cpu"


@functools.lru_cache(maxsize=None)
def make_solver(model: str):
    return ba.make_ba_solver(
        make_residual_fn(model), cam_retract, 6,
        rj_fn=make_rj_fn(model) if _use_manual_jacobians() else None,
    )


@functools.lru_cache(maxsize=None)
def make_fused_solver(model: str):
    from photometric_bundle_adjustment_tpu.optim import fused

    return fused.make_fused_ba_solver(
        make_residual_fn(model), cam_retract, 6,
        rj_fn=make_rj_fn(model) if _use_manual_jacobians() else None,
    )


def build_problem(
    poses: jax.Array,          # (K, 7)
    inv_depth: jax.Array,      # (L,)
    anchor_cam: jax.Array,     # (O,) anchor camera index per obs
    target_cam: jax.Array,     # (O,)
    landmark: jax.Array,       # (O,)
    uv_target: jax.Array,      # (O, 2)
    uv_ref: jax.Array,         # (O, 2)
    intr_ref: jax.Array,       # (O, 8)
    intr_target: jax.Array,    # (O, 8)
    valid: jax.Array,          # (O,) bool
    fixed_cams: jax.Array,     # (K,) bool
    lm_valid: jax.Array | None = None,
) -> ba.BAProblem:
    import numpy as _np

    def _cast(x, dt_jax, dt_np):
        # numpy inputs stay numpy: the incremental pipeline builds its
        # problems host-side so bundle_adjustment's densify reorder runs
        # without a device->host fetch per array; jit canonicalizes the
        # single upload at dispatch
        if isinstance(x, jax.Array):
            return jnp.asarray(x, dt_jax)
        return _np.asarray(x, dt_np)

    if lm_valid is None:
        lm_valid = _np.ones(_np.shape(inv_depth), bool)
    obs = ba.BAObservations(
        anchor_cam=_cast(anchor_cam, jnp.int32, _np.int32),
        target_cam=_cast(target_cam, jnp.int32, _np.int32),
        landmark=_cast(landmark, jnp.int32, _np.int32),
        aux=GeometricObs(
            uv_target=uv_target,
            uv_ref=uv_ref,
            intr_ref=intr_ref,
            intr_target=intr_target,
        ),
        valid=_cast(valid, inv_depth.dtype, inv_depth.dtype),
    )
    return ba.BAProblem(
        cam_states=poses,
        inv_depth=inv_depth,
        obs=obs,
        fixed_cams=_cast(fixed_cams, bool, bool),
        lm_valid=_cast(lm_valid, bool, bool),
    )


def _device_pair_plan(an, tn, valid, K: int, NCpb: int, B: int):
    """Rebuild the camera-pair Gram plan (pg, cc_rows4) ON DEVICE.

    Bit-identical re-derivation of schur_plan._chunk_segments' pair plan
    from the (anchor_cam, target_cam, valid) arrays that ride the packed
    upload anyway: at EuRoC scale the host-built (32768, 32) ``pg`` table
    alone was 4.2 MB of the 7.6 MB per-solve upload, while the arrays it
    derives from are 3 x 131 KB.  Same sort-order contract as the host build (stable sort
    of pair ids with invalid rows keyed past every real pair, segment-
    then-chunk numbering in sorted order), so the assembled sums are
    bit-identical; verified by test_bundle_adjustment_packed_matches_
    unpacked.  Works for both plan families (SchurPlan over original
    rows, DenseLmSchurPlan over slot-major padded rows) because both
    build their pair chunks from exactly these three arrays.

    Static args: K (camera bucket), NCpb (chunk-row bucket from the host
    plan's shape), B (pair_chunk).  Ref: the block-sparse structures
    Ceres builds at solve time for SPARSE_SCHUR,
    /root/reference/include/visnav/map_utils.h:377-383.
    """
    KK = K * K
    pid = jnp.where(
        valid, an.astype(jnp.int32) * K + tn.astype(jnp.int32), KK
    )
    pg, prow = _device_chunk_plan(pid, KK, NCpb, B)
    pa, pc = prow // K, prow % K
    rows4 = jnp.stack(
        [pa * K + pa, pa * K + pc, pc * K + pa, pc * K + pc], axis=1
    )
    cc_rows4 = jnp.where((prow == KK)[:, None], KK, rows4).astype(jnp.int32)
    return pg, cc_rows4


def _device_chunk_plan(pid, R: int, NCb: int, B: int):
    """Device analog of schur_plan._chunk_segments + its bucketed fill:
    ``pid`` (O,) int32 output-row keys with INVALID entries pre-set to
    ``R`` (all real keys < R); returns (gidx (NCb, B) int32 obs ids with
    O-dummies, rows (NCb,) int32 with R-dummies) — bit-identical to the
    host build's fill conventions (same stable sort order,
    segment-then-chunk numbering).  All shapes static; the whole thing is
    one sort + cumsum/cummax + two dropped scatters, in place of the
    MB-scale upload of the host table it replaces."""
    O = pid.shape[0]
    order = jnp.argsort(pid, stable=True)
    sids = pid[order]
    sv = sids < R
    io = jnp.arange(O, dtype=jnp.int32)
    new_seg = sv & ((io == 0) | (sids != jnp.roll(sids, 1)))
    # position within segment: distance to the latest segment start
    start = jax.lax.cummax(jnp.where(new_seg, io, -1))
    pos = io - start
    slot = pos % B
    new_chunk = sv & (new_seg | (slot == 0))
    cid = jnp.cumsum(new_chunk.astype(jnp.int32)) - 1
    cid_s = jnp.where(sv, cid, NCb)           # invalid rows: dropped
    gidx = (
        jnp.full((NCb, B), O, jnp.int32)
        .at[cid_s, slot].set(order.astype(jnp.int32), mode="drop")
    )
    rows = (
        jnp.full((NCb,), R, jnp.int32)
        .at[cid_s].set(sids, mode="drop")
    )
    return gidx, rows


@functools.lru_cache(maxsize=None)
def _packed_solver(model: str):
    """Jitted solve over PACKED (problem, plan) buffers: one upload per
    dtype + one dispatch + one packed fetch, instead of ~20 per-array
    transfers.  The per-observation intrinsics rows ride
    COMPACTED (a uint8 physical-camera index per obs + the (n_cams, 8)
    table — they are ~half the per-solve upload bytes expanded) and are
    re-expanded by a device row-gather.  Unpacking is static slicing
    inside jit."""
    import jax as _jax
    import jax.numpy as _jnp

    from photometric_bundle_adjustment_tpu.utils import pack as pack_mod

    solver = make_fused_solver(model)

    @functools.partial(_jax.jit, static_argnames=("cfg", "spec", "pgs"))
    def run(buffers, cfg, spec, pgs=None):
        tree = pack_mod.unpack_tree_bytes(buffers, spec)
        problem, plan, ir_idx, it_idx, intr_tab = tree[:5]
        proj = tree[5] if len(tree) > 5 else None
        aux = problem.obs.aux._replace(
            intr_ref=intr_tab[ir_idx], intr_target=intr_tab[it_idx]
        )
        problem = problem._replace(
            obs=problem.obs._replace(aux=aux)
        )
        if pgs is not None:
            # pair-Gram plan rebuilt on device from the shipped obs graph
            # (the host table was ~55% of the per-solve upload bytes)
            NCpb, Bp = pgs
            K_ = _jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
            pg, cc4 = _device_pair_plan(
                problem.obs.anchor_cam, problem.obs.target_cam,
                problem.obs.valid != 0, K_, NCpb, Bp,
            )
            plan = plan._replace(pg=pg, cc_rows4=cc4)
        solved, res = solver(problem, plan, cfg)
        dt = solved.cam_states.dtype
        out = [
            solved.cam_states.reshape(-1),
            solved.inv_depth.astype(dt),
            _jnp.stack([res.cost.astype(dt), res.initial_cost.astype(dt),
                        res.lam.astype(dt),
                        res.iterations.astype(dt)]),
        ]
        if proj is not None:
            # outlier-pass reprojection CHAINED onto the solved state in
            # the SAME dispatch: the following remove_outliers stage then
            # needs no separate upload/dispatch/fetch round trips
            from photometric_bundle_adjustment_tpu.core import se3 as _se3
            from photometric_bundle_adjustment_tpu.core import (
                cameras as _cams,
            )

            poses = solved.cam_states
            T_a = poses[proj["an_idx"]]
            T_t = poses[proj["cam_idx"]]
            rho_r = solved.inv_depth[proj["lm_idx"]].astype(dt)
            intr_a = proj["intr_tab"][proj["ia_idx"]]
            intr_t = proj["intr_tab"][proj["it_idx"]]
            d = _cams.unproject_unit(model, intr_a, proj["uv_a"])
            p_w = _se3.act(T_a, d / rho_r[:, None])
            p_c = _se3.act(_se3.inverse(T_t), p_w)
            uv_proj = _cams.project(model, intr_t, p_c)
            err = _jnp.linalg.norm(proj["uv_meas"] - uv_proj, axis=-1)
            dist = _jnp.linalg.norm(p_c, axis=-1)
            out.append(_jnp.concatenate([
                uv_proj, err[:, None], dist[:, None], p_c[:, 2:3]
            ], axis=1).astype(dt).reshape(-1))
        return _jnp.concatenate(out)

    return run


def bundle_adjustment_packed(
    problem: ba.BAProblem,
    model: str,
    cfg: ba.BAConfig = ba.BAConfig(),
    proj: dict | None = None,
):
    """Accelerator fast path for the incremental pipeline's BA stage:
    same solve as :func:`bundle_adjustment`, but (problem, plan) ride to
    the device as per-dtype packed buffers and the results come back in
    one packed fetch.

    ``proj``: optional outlier-pass reprojection rows (numpy dict with
    uv_a, ia_idx, an_idx, uv_meas, it_idx, cam_idx, lm_idx, intr_tab) —
    evaluated against the SOLVED state inside the same dispatch; the
    packed (M, 5) [uv_proj, err, dist, z] block returns with the solve.

    Returns ``(poses (K, 7) np, inv_depth (L,) np, BAResult-host,
    proj_out (M, 5) np | None)``.  Requires a host-resident (numpy)
    problem.  Ref: the Ceres solve being replaced,
    include/visnav/map_utils.h:322-399, and the compute_projections scan
    it feeds, src/sfm.cpp:1957-2008.
    """
    import numpy as _np

    from photometric_bundle_adjustment_tpu.utils import pack as pack_mod

    problem, plan = _accel_plan(problem)
    # compact the per-obs intrinsics rows to indices into the table of
    # UNIQUE rows (EuRoC: 2 physical cameras -> 2 rows)
    aux = problem.obs.aux
    ir = _np.asarray(aux.intr_ref)
    it = _np.asarray(aux.intr_target)
    intr_tab, inv = _np.unique(
        _np.concatenate([ir, it]), axis=0, return_inverse=True
    )
    assert intr_tab.shape[0] < 256, "intr row table exceeds uint8 index"
    O_ = ir.shape[0]
    ir_idx = inv[:O_].astype(_np.uint8)
    it_idx = inv[O_:].astype(_np.uint8)
    slim = problem._replace(obs=problem.obs._replace(aux=aux._replace(
        intr_ref=_np.zeros((0,), ir.dtype),
        intr_target=_np.zeros((0,), it.dtype),
    )))
    # the pair-Gram tables are rebuilt on device from the obs graph
    # (_device_pair_plan); ship empty placeholders + their static shape
    pgs = (int(plan.pg.shape[0]), int(plan.pg.shape[1]))
    plan_slim = plan._replace(
        pg=_np.zeros((0, plan.pg.shape[1]), _np.int32),
        cc_rows4=_np.zeros((0, 4), _np.int32),
    )
    tree = (slim, plan_slim, ir_idx, it_idx, intr_tab)
    if proj is not None:
        tree = tree + (proj,)
    buffers, spec = pack_mod.pack_tree_bytes(tree)
    import jax.numpy as _jnp

    packed = _np.asarray(_packed_solver(model)(
        _jnp.asarray(buffers), cfg, spec, pgs
    ))
    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    poses = packed[: K * 7].reshape(K, 7)
    rho = packed[K * 7: K * 7 + L]
    cost, icost, lam, iters = packed[K * 7 + L: K * 7 + L + 4]
    proj_out = None
    if proj is not None:
        proj_out = packed[K * 7 + L + 4:].reshape(-1, 5)
    return poses, rho, ba.BAResult(
        cost=float(cost), initial_cost=float(icost),
        iterations=int(iters), lam=float(lam),
    ), proj_out


def _accel_plan(problem: ba.BAProblem):
    """Accelerator plan choice shared by bundle_adjustment and the packed
    path: slot-major dense when the padding is modest, ragged chunk plan
    for heavy-tailed maps (see the guard comment in bundle_adjustment)."""
    import numpy as _np2

    from photometric_bundle_adjustment_tpu.optim import fused

    o = problem.obs
    ln = _np2.asarray(o.landmark)
    vm = _np2.asarray(o.valid) != 0
    L_ = problem.inv_depth.shape[0]
    n_valid = max(int(vm.sum()), 1)
    smax = int(_np2.bincount(ln[vm], minlength=L_).max()) if vm.any() else 1
    if smax * L_ <= 3 * n_valid:
        return fused.densify_problem(problem)
    return problem, fused.plan_for_problem(problem, host=False)


def bundle_adjustment(
    problem: ba.BAProblem,
    model: str,
    cfg: ba.BAConfig = ba.BAConfig(),
    use_fused: bool | None = None,
):
    """Run the full jitted Schur-LM solve; returns (problem, BAResult).

    Matches the reference's defaults: Huber 1 px, 20 iterations
    (BundleAdjustmentOptions, map_utils.h:304-319).

    ``use_fused`` selects the plan-based fused assembly (optim.fused) —
    faster on a single device; ``None`` means auto (fused).

    On accelerators the problem is host-reordered into the slot-major
    landmark-dense layout first (fused.densify_problem, pow2-bucketed so
    growing maps reuse compiled code) — the dense build runs ~1.8x faster
    than the chunk-plan build (optim/fused.py build_dense).  Only the
    observation ORDER changes; the returned problem's cam_states and
    inv_depth are directly those of the input problem's indexing.
    """
    if use_fused is None or use_fused:
        import os as _os

        import jax as _jax

        from photometric_bundle_adjustment_tpu.optim import fused

        if _os.environ.get("PBA_DUMP_BA_PROBLEM"):
            import pickle as _pickle

            d = _os.environ["PBA_DUMP_BA_PROBLEM"]
            _os.makedirs(d, exist_ok=True)
            n = len(_os.listdir(d))
            import numpy as _np

            with open(f"{d}/ba_problem_{n:03d}.pkl", "wb") as f:
                _pickle.dump(
                    {"problem": _jax.tree_util.tree_map(_np.asarray, problem),
                     "model": model}, f,
                )
        if _jax.default_backend() == "cpu":
            plan = fused.plan_for_problem(problem)
        else:
            # slot-expansion guard: the slot-major dense layout pads O
            # observations to S_max * L rows.  Real incremental maps are
            # heavy-tailed (EuRoC: max ~96 obs/landmark vs ~5 mean), so
            # densifying them inflates the per-solve upload ~30x.
            # Keep the dense layout only when the padding is modest;
            # otherwise use the ragged chunk plan (same results, O-row
            # payloads).  Policy shared with the packed path (_accel_plan).
            problem, plan = _accel_plan(problem)
        return make_fused_solver(model)(problem, plan, cfg)
    solve = make_solver(model)
    return solve(problem, cfg)
