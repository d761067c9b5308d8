"""Distributed fused-assembly bundle adjustment over a device mesh.

Combines the two performance layers of the framework:

  * the plan-based fused Schur assembly of ``optim.fused`` (no scatter-adds,
    no materialised H_cp, analytic lambda damping), and
  * the landmark-sharded data parallelism of ``parallel.dist_ba``
    (SURVEY §2.3 / §7 step 7: observation + landmark axes sharded, camera
    state replicated),

as an explicit ``shard_map`` program: each device assembles the
camera-sized normal-equation pieces for its landmark shard with its own
host-precomputed plan, the ONLY collectives are ``psum`` of the reduced
camera system (H_cc, S_corr0, rhs_corr0, g_c — all O(K^2 C^2), independent
of the landmark count), the dense Cholesky runs replicated, and the
landmark back-substitution is shard-local.

Shards are **landmark-aligned**: a landmark's observations (and therefore
its Schur entry pairs) always live on one device, assigned by balancing
observation counts over contiguous landmark ranges.  This replaces the
reference's shared-memory TBB/Ceres-threads parallelism
(include/visnav/map_utils.h:377-383) with collective-based data parallelism.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
from jax import shard_map
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from photometric_bundle_adjustment_tpu.optim import ba, fused
from photometric_bundle_adjustment_tpu.optim.schur_plan import (
    ChunkPlan,
    DenseLmSchurPlan,
    SchurPlan,
    build_dense_lm_plan,
    build_schur_plan,
)
from photometric_bundle_adjustment_tpu.parallel.mesh import DATA_AXIS


class ShardedFusedProblem(NamedTuple):
    """A BAProblem split into landmark-aligned shards (leading axis = D)
    plus per-shard assembly plans (padded to common shapes)."""

    problem: ba.BAProblem       # obs/landmark arrays (D*O_s,)/(D*L_s,), cams (K,...)
    plans: SchurPlan            # SchurPlan or DenseLmSchurPlan, stacked (D, ...)
    n_shards: int
    # original landmark id -> row in the padded (D*L_s,) landmark arrays
    # (callers writing solved depths back into a host map need it)
    lm_global_index: np.ndarray | None = None


def _pad_leading(x: np.ndarray, n: int, fill) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.full((n - x.shape[0],) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad])


def prepare(problem: ba.BAProblem, mesh: Mesh,
            layout: str = "chunk") -> ShardedFusedProblem:
    """Host-side: sort observations by landmark, assign contiguous landmark
    ranges to shards balancing observation counts, localise landmark
    indices, pad every shard to common (O_s, L_s), and build one plan per
    shard (padded to common chunk counts).

    ``layout="dense"`` uses the landmark-dense observation layout
    (optim.schur_plan.DenseLmSchurPlan): each shard's rows are reordered
    into (L_s, S) slots with a common S, so the landmark-axis reductions
    of the fused build are reshapes on every device — the composition of
    the single-chip dense layout with the landmark-sharded distribution.
    Shards are landmark-aligned either way, so the dense reorder is purely
    shard-local (no cross-device movement)."""
    D = mesh.devices.size
    o = problem.obs
    an = np.asarray(o.anchor_cam)
    tn = np.asarray(o.target_cam)
    ln = np.asarray(o.landmark)
    valid = np.asarray(o.valid) != 0
    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]

    order = np.argsort(ln, kind="stable")
    # landmark -> shard by balancing valid-obs counts over contiguous ranges
    obs_per_lm = np.bincount(ln[valid], minlength=L)
    target = max(1.0, obs_per_lm.sum() / D)
    cum = np.cumsum(obs_per_lm)
    lm_shard = np.minimum((cum - 1e-9) // target, D - 1).astype(np.int64)
    lm_shard = np.maximum.accumulate(lm_shard)  # monotone over landmark id

    obs_shard = lm_shard[ln]
    L_s = int(np.bincount(lm_shard, minlength=D).max())
    O_s = int(np.bincount(obs_shard[order], minlength=D).max())
    if layout == "dense":
        # common slot count across shards so padded shapes agree
        from photometric_bundle_adjustment_tpu.optim.schur_plan import (
            _round_up,
        )

        S_common = _round_up(
            max(1, int(np.bincount(ln[valid], minlength=L).max())), 2
        )
        O_s = L_s * S_common

    lm_start = np.searchsorted(lm_shard, np.arange(D))
    lm_count = np.bincount(lm_shard, minlength=D)

    def np_of(x):
        return np.asarray(x)

    aux_leaves, aux_tree = jax.tree_util.tree_flatten(o.aux)
    aux_np = [np_of(x) for x in aux_leaves]

    obs_fields = {
        "anchor_cam": an, "target_cam": tn,
        "valid": np.asarray(o.valid),
    }
    shards = {k: [] for k in obs_fields}
    shards["landmark"] = []
    aux_shards = [[] for _ in aux_np]
    inv_shards, lmv_shards, plans = [], [], []

    inv_np = np.asarray(problem.inv_depth)
    lmv_np = np.asarray(problem.lm_valid)

    for d in range(D):
        sel = order[obs_shard[order] == d]
        ln_local = ln[sel] - lm_start[d]
        for k, src in obs_fields.items():
            shards[k].append(_pad_leading(src[sel], O_s, 0))
        shards["landmark"].append(
            _pad_leading(ln_local.astype(np.int64), O_s, 0)
        )
        for i, src in enumerate(aux_np):
            aux_shards[i].append(_pad_leading(src[sel], O_s, 0))
        lo, n_lm = lm_start[d], lm_count[d]
        inv_shards.append(_pad_leading(inv_np[lo : lo + n_lm], L_s, 1.0))
        lmv_shards.append(_pad_leading(lmv_np[lo : lo + n_lm], L_s, False))
        valid_local = _pad_leading(valid[sel], O_s, False)
        if layout == "dense":
            perm, plan_d = build_dense_lm_plan(
                shards["anchor_cam"][-1], shards["target_cam"][-1],
                shards["landmark"][-1], K, L_s, valid=valid_local,
                slots=S_common,
            )
            take = np.where(perm >= 0, perm, 0)
            filled = perm >= 0
            for k in shards:
                arr = shards[k][-1][take]
                if k != "landmark":
                    arr = np.where(filled, arr, 0)
                else:
                    # slot-major: padded row s*L_s + l observes landmark l
                    arr = np.tile(np.arange(L_s), S_common)
                shards[k][-1] = arr
            for i in range(len(aux_shards)):
                a = aux_shards[i][-1][take]
                sel2 = filled.reshape((-1,) + (1,) * (a.ndim - 1))
                aux_shards[i][-1] = np.where(sel2, a, np.zeros_like(a))
            plans.append(plan_d)
        else:
            plans.append(
                build_schur_plan(
                    shards["anchor_cam"][-1], shards["target_cam"][-1],
                    shards["landmark"][-1], K, L_s, valid=valid_local,
                )
            )

    # pad plans to common chunk counts (dummy rows follow each plan's own
    # conventions: gidx -> payload-zero row, rows -> dropped output row)
    def stack_plans(get, dummy):
        arrs = [get(p) for p in plans]
        n = max(a.shape[0] for a in arrs)
        return np.stack([_pad_leading(a, n, dummy) for a in arrs])

    if layout == "dense":
        stacked = DenseLmSchurPlan(
            pg=stack_plans(lambda p: p.pg, O_s),
            cc_rows4=stack_plans(lambda p: p.cc_rows4, K * K),
            obs_anchor_cam=np.stack([p.obs_anchor_cam for p in plans]),
            obs_target_cam=np.stack([p.obs_target_cam for p in plans]),
            lm_cam=np.stack([p.lm_cam for p in plans]),
            anchor_cam_of_lm=np.stack([p.anchor_cam_of_lm for p in plans]),
        )
    else:
        stacked = SchurPlan(
            pg=stack_plans(lambda p: p.pg, O_s),
            cc_rows4=stack_plans(lambda p: p.cc_rows4, K * K),
            lm=ChunkPlan(
                gidx=stack_plans(lambda p: p.lm.gidx, O_s),
                rows=stack_plans(lambda p: p.lm.rows, L_s),
            ),
            gc_a=ChunkPlan(
                gidx=stack_plans(lambda p: p.gc_a.gidx, O_s),
                rows=stack_plans(lambda p: p.gc_a.rows, K),
            ),
            gc_t=ChunkPlan(
                gidx=stack_plans(lambda p: p.gc_t.gidx, O_s),
                rows=stack_plans(lambda p: p.gc_t.rows, K),
            ),
            lm_cam=stack_plans(lambda p: p.lm_cam, K),
            anchor_cam_of_lm=stack_plans(lambda p: p.anchor_cam_of_lm, K),
        )

    dtype = inv_np.dtype
    obs = ba.BAObservations(
        anchor_cam=jnp.asarray(np.concatenate(shards["anchor_cam"])),
        target_cam=jnp.asarray(np.concatenate(shards["target_cam"])),
        landmark=jnp.asarray(np.concatenate(shards["landmark"]).astype(np.int32)),
        aux=jax.tree_util.tree_unflatten(
            aux_tree, [jnp.asarray(np.concatenate(a)) for a in aux_shards]
        ),
        valid=jnp.asarray(np.concatenate(shards["valid"]).astype(dtype)),
    )
    sharded_problem = ba.BAProblem(
        cam_states=problem.cam_states,
        inv_depth=jnp.asarray(np.concatenate(inv_shards)),
        obs=obs,
        fixed_cams=problem.fixed_cams,
        lm_valid=jnp.asarray(np.concatenate(lmv_shards)),
    )

    # place on the mesh
    data = NamedSharding(mesh, P(DATA_AXIS))
    repl = NamedSharding(mesh, P())
    sharded_problem = ba.BAProblem(
        cam_states=jax.tree_util.tree_map(
            lambda x: jax.device_put(x, repl), sharded_problem.cam_states
        ),
        inv_depth=jax.device_put(sharded_problem.inv_depth, data),
        obs=jax.tree_util.tree_map(
            lambda x: jax.device_put(x, data), sharded_problem.obs
        ),
        fixed_cams=jax.device_put(sharded_problem.fixed_cams, repl),
        lm_valid=jax.device_put(sharded_problem.lm_valid, data),
    )
    plans_dev = jax.tree_util.tree_map(
        lambda x: jax.device_put(jnp.asarray(x), data), stacked
    )
    lm_global_index = (
        lm_shard * L_s + np.arange(L, dtype=np.int64) - lm_start[lm_shard]
    )
    return ShardedFusedProblem(sharded_problem, plans_dev, D,
                               lm_global_index)


def make_distributed_fused_solver(
    residual_fn, cam_retract, cam_tangent_dim, mesh: Mesh, rj_fn=None,
    camera_partition: bool = False, n_cg: int = 200, cg_tol: float = 1e-12,
):
    """Returns solve(sharded: ShardedFusedProblem, cfg) -> (problem, BAResult).

    The entire LM loop runs as one shard_map program; collectives per
    normal-equation build: one psum of (cost, H_cc, S_corr0, rhs_corr0,
    g_c); per cost evaluation: one psum of the scalar cost.

    ``camera_partition=True`` switches the reduced-camera-system solve from
    the replicated dense Cholesky to a CAMERA-ROW-PARTITIONED conjugate
    gradient (SURVEY §7 step 7 model parallelism; the distributed analog of
    Ceres SPARSE_SCHUR's reduced solve, map_utils.h:377-383):

      * the (KC x KC) reduced matrix is never assembled replicated — each
        device owns a KC/D row slice via one ``psum_scatter`` of its local
        Gram contribution, and the Schur correction S_corr0 is never
        materialised at all: its action  M^T diag(inv_hpp/(1+lam)) M v
        is evaluated matrix-free against the LANDMARK-SHARDED M each CG
        step (the local M_d is exactly what the fused build already has);
      * CG state (x, r, p, z) lives camera-row-sharded; per iteration the
        collectives are one ``all_gather`` of the search direction (KC
        floats), one ``psum_scatter`` of the Schur matvec and two scalar
        ``psum`` dot products — all O(KC), independent of landmarks;
      * preconditioner: exact block-Jacobi of S(lam) — the C x C diagonal
        blocks including the Schur-correction diagonal (one small psum of
        a (K, C, C) einsum over local M rows at build time);
      * per-device memory for the reduced system drops from O(K^2 C^2)
        (replicated factor) to O(K^2 C^2 / D) rows (the O(K^2 C^2)
        assembly transient remains; chunked assembly+scatter can remove it
        when K grows past ~4k).

    ``n_cg`` bounds CG iterations; the loop exits early at relative
    residual ``cg_tol``.  LM is robust to the slightly inexact step (the
    accept/reject check still guards every update).
    """
    solver = fused.make_fused_ba_solver(
        residual_fn, cam_retract, cam_tangent_dim, rj_fn=rj_fn
    )
    res_cost_local, _ = ba.make_ba_step(
        residual_fn, cam_retract, cam_tangent_dim, rj_fn=rj_fn
    )

    def solve(sharded: ShardedFusedProblem, cfg: ba.BAConfig = ba.BAConfig()):
        D = sharded.n_shards

        def local_views(problem, plans):
            plan = jax.tree_util.tree_map(lambda x: x[0], plans)
            return problem, plan

        @functools.partial(
            shard_map,
            mesh=mesh,
            in_specs=(
                ba.BAProblem(
                    cam_states=jax.tree_util.tree_map(
                        lambda _: P(), sharded.problem.cam_states
                    ),
                    inv_depth=P(DATA_AXIS),
                    obs=jax.tree_util.tree_map(
                        lambda _: P(DATA_AXIS), sharded.problem.obs
                    ),
                    fixed_cams=P(),
                    lm_valid=P(DATA_AXIS),
                ),
                jax.tree_util.tree_map(lambda _: P(DATA_AXIS), sharded.plans),
            ),
            out_specs=(
                ba.BAProblem(
                    cam_states=jax.tree_util.tree_map(
                        lambda _: P(), sharded.problem.cam_states
                    ),
                    inv_depth=P(DATA_AXIS),
                    obs=jax.tree_util.tree_map(
                        lambda _: P(DATA_AXIS), sharded.problem.obs
                    ),
                    fixed_cams=P(),
                    lm_valid=P(DATA_AXIS),
                ),
                ba.BAResult(cost=P(), initial_cost=P(), iterations=P(),
                            lam=P(), cg_iterations=P()),
            ),
            check_vma=False,
        )
        def run(problem, plans):
            prob, plan = local_views(problem, plans)
            free = ~prob.fixed_cams
            dtype = prob.inv_depth.dtype

            def cost_fn(p):
                return jax.lax.psum(res_cost_local(p, cfg), DATA_AXIS)

            def build_psum(p):
                cost, neq = solver.build(p, plan, cfg)
                H_cc, S0, rhs0, H_pp, g_c, g_p, M, inv0 = neq
                cost, H_cc, S0, rhs0, g_c = jax.lax.psum(
                    (cost, H_cc, S0, rhs0, g_c), DATA_AXIS
                )
                return cost, (H_cc, S0, rhs0, H_pp, g_c, g_p, M, inv0)

            C_ = cam_tangent_dim
            K = sharded.problem.fixed_cams.shape[0]
            Kp = ((K + D - 1) // D) * D       # camera-granular row padding
            KpD = Kp // D                      # cameras per device row-slice
            KC, KCp = K * C_, Kp * C_

            def build_part(p):
                """Partitioned build: local Gram rows scattered to the
                owning device, Schur correction left as (M, inv0) for
                matrix-free application; no (KC x KC) product anywhere."""
                cfg_p = cfg._replace(skip_schur_gram=True)
                cost, neq = solver.build(p, plan, cfg_p)
                H_cc_mat, _, rhs_corr0, H_pp, g_c, g_p, M, inv0 = neq
                cost, g_c, rhs_corr0 = jax.lax.psum(
                    (cost, g_c, rhs_corr0), DATA_AXIS
                )
                d_cc = jax.lax.psum(jnp.diagonal(H_cc_mat), DATA_AXIS)
                # DEVICE-BLOCK diagonal of the Schur correction: the
                # (KpD*C x KpD*C) diagonal block each device owns, summed
                # over the landmark shards (psum_scatter hands each device
                # only its own block).  Round-3 scale-stress showed the
                # C x C block-Jacobi preconditioner leaves CG at its
                # iteration cap at every size; camera coupling in a
                # trajectory is temporally local, so the device-sized
                # additive-Schwarz block (~K/D consecutive cameras)
                # captures most of it and the per-iteration apply is one
                # local cho_solve with no collectives.
                nd = mesh.devices.size
                Mpad = jnp.zeros((M.shape[0], Kp * C_), M.dtype)
                Mpad = Mpad.at[:, :KC].set(M)
                Mblk = Mpad.reshape(-1, nd, KpD * C_)
                Sblk = jnp.einsum("ldi,l,ldj->dij", Mblk, inv0, Mblk)
                Sblk_loc = jax.lax.psum_scatter(
                    Sblk, DATA_AXIS, scatter_dimension=0, tiled=True
                )[0]                             # (KpD*C, KpD*C)
                H_pad = jnp.zeros((KCp, KCp), H_cc_mat.dtype)
                H_pad = H_pad.at[:KC, :KC].set(H_cc_mat)
                H_rows = jax.lax.psum_scatter(
                    H_pad, DATA_AXIS, scatter_dimension=0, tiled=True
                )                                # (KpD*C, KCp)
                return cost, (H_rows, rhs_corr0, H_pp, g_c, g_p, M, inv0,
                              Sblk_loc, d_cc)

            def solve_lam_part(neqp, lam):
                """Camera-row-partitioned PCG on the reduced system
                S(lam) x = rhs; returns (delta_c (K, C) replicated,
                delta_p shard-local)."""
                (H_rows, rhs_corr0, H_pp, g_c, g_p, M, inv0, Sblk_loc,
                 d_cc) = neqp
                dtype = g_c.dtype
                didx = jax.lax.axis_index(DATA_AXIS)
                row0 = didx * (KpD * C_)

                maskK = jnp.zeros(Kp, dtype).at[:K].set(free.astype(dtype))
                maskp = jnp.repeat(maskK, C_)             # (KCp,)
                mask_loc = jax.lax.dynamic_slice(
                    maskp, (row0,), (KpD * C_,)
                )
                d_cl = jnp.clip(d_cc, 1e-12, 1e32)
                d_pad = jnp.zeros(KCp, dtype).at[:KC].set(d_cl)
                d_loc = jax.lax.dynamic_slice(d_pad, (row0,), (KpD * C_,))

                rhs = -(g_c.reshape(-1) - rhs_corr0 / (1.0 + lam))
                rhs_pad = (jnp.zeros(KCp, dtype).at[:KC].set(rhs)) * maskp
                rhs_loc = jax.lax.dynamic_slice(
                    rhs_pad, (row0,), (KpD * C_,)
                )

                # device-block additive-Schwarz preconditioner: the local
                # (KpD*C x KpD*C) diagonal block of S(lam) = H + lam D -
                # S_corr/(1+lam), Cholesky-factored once per lambda.
                # Identity rows/cols on fixed/pad cameras keep it SPD on
                # the masked subspace.  (The previous C x C block-Jacobi
                # left CG AT ITS ITERATION CAP at cg_tol=1e-7 for every
                # problem size in the round-3 scale-stress table.)
                nloc = KpD * C_
                Hblk_big = jax.lax.dynamic_slice(
                    H_rows, (jnp.zeros((), didx.dtype), row0), (nloc, nloc)
                )
                B = (Hblk_big - Sblk_loc / (1.0 + lam)
                     + jnp.diag(lam * d_loc))
                B = (B * mask_loc[:, None] * mask_loc[None, :]
                     + jnp.diag(1.0 - mask_loc))
                choB = jax.scipy.linalg.cho_factor(B, lower=True)

                # ---- coarse level (two-level additive Schwarz) --------
                # The device blocks capture local temporal coupling but
                # none of the trajectory's low-frequency error modes, so
                # CG stalls on them (round-3/4 scale-stress: the cap
                # binds at small/medium).  Deflate them with a coarse
                # space Z of piecewise-constant-per-device tangent
                # directions (one column per (device, tangent dim), DC
                # columns total): E = Z^T S(lam) Z is (D*C x D*C),
                # assembled exactly from the pieces already in hand (one
                # psum of a (C, DC) block-row + one psum of the MZ Gram)
                # and Cholesky-factored replicated.  Apply cost per CG
                # step: one (C,)-payload all_gather + a DC-dim
                # triangular solve.  P^-1 = B^-1 + Z E^-1 Z^T stays SPD.
                nd_ = mesh.devices.size
                DC = nd_ * C_
                Hm = H_rows * mask_loc[:, None] * maskp[None, :]
                # Z_d^T H_rows: reduce local rows per tangent dim, then
                # group the KCp columns by owning device
                blkrow = (
                    Hm.reshape(KpD, C_, KCp).sum(0)
                      .reshape(C_, nd_, KpD, C_).sum(2)
                      .reshape(C_, DC)
                )
                rowsel = (jnp.arange(nd_) == didx).astype(dtype)
                A_coarse = jax.lax.psum(
                    rowsel[:, None, None] * blkrow[None], DATA_AXIS
                ).reshape(DC, DC)
                # lam * d term: diagonal per coarse dim (groups disjoint)
                dcoarse_loc = (lam * d_loc * mask_loc).reshape(
                    KpD, C_).sum(0)                        # (C_,)
                dcoarse = jax.lax.all_gather(
                    dcoarse_loc, DATA_AXIS, tiled=True
                )                                          # (DC,)
                # Schur-correction term: MZ Gram over landmark shards
                Mp = jnp.zeros((M.shape[0], KCp), M.dtype)
                Mp = Mp.at[:, :KC].set(M * maskp[None, :KC])
                MZ = Mp.reshape(-1, nd_, KpD, C_).sum(2).reshape(-1, DC)
                E_corr = jax.lax.psum(
                    MZ.T @ (inv0[:, None] * MZ), DATA_AXIS
                )
                cmask_loc = (mask_loc.reshape(KpD, C_).sum(0) > 0
                             ).astype(dtype)
                cmask = jax.lax.all_gather(
                    cmask_loc, DATA_AXIS, tiled=True
                )                                          # (DC,)
                E = (A_coarse + jnp.diag(dcoarse)
                     - E_corr / (1.0 + lam))
                E = (E * cmask[:, None] * cmask[None, :]
                     + jnp.diag(1.0 - cmask))
                choE = jax.scipy.linalg.cho_factor(E, lower=True)

                def precond(r):
                    zb = jax.scipy.linalg.cho_solve(choB, r) * mask_loc
                    rc_loc = (r * mask_loc).reshape(KpD, C_).sum(0)
                    rc = jax.lax.all_gather(
                        rc_loc, DATA_AXIS, tiled=True
                    )
                    y = jax.scipy.linalg.cho_solve(choE, rc * cmask) * cmask
                    y_loc = jax.lax.dynamic_slice(y, (didx * C_,), (C_,))
                    zc = jnp.tile(y_loc, KpD) * mask_loc
                    return zb + zc

                def matvec(p_loc):
                    p_full = jax.lax.all_gather(
                        p_loc, DATA_AXIS, tiled=True
                    ) * maskp                                   # (KCp,)
                    hv = H_rows @ p_full                        # local rows
                    hv = hv + lam * d_loc * jax.lax.dynamic_slice(
                        p_full, (row0,), (KpD * C_,)
                    )
                    y = (M @ p_full[:KC]) * inv0                # (L_s,)
                    w = (M.T @ y) / (1.0 + lam)                 # (KC,)
                    w_pad = jnp.zeros(KCp, dtype).at[:KC].set(w)
                    w_loc = jax.lax.psum_scatter(
                        w_pad, DATA_AXIS, scatter_dimension=0, tiled=True
                    )
                    return (hv - w_loc) * mask_loc

                def dot(a, b):
                    return jax.lax.psum(jnp.vdot(a, b), DATA_AXIS)

                x = jnp.zeros_like(rhs_loc)
                r = rhs_loc
                z = precond(r)
                p_dir = z
                rz = dot(r, z)
                rhs_nrm = dot(rhs_loc, rhs_loc)

                def cg_cond(s):
                    _, r, _, _, _, it = s
                    rr = dot(r, r)
                    return (it < n_cg) & (rr > cg_tol * cg_tol * rhs_nrm)

                def cg_body(s):
                    x, r, z, p_dir, rz, it = s
                    Sp = matvec(p_dir)
                    den = dot(p_dir, Sp)
                    alpha = rz / jnp.where(den != 0.0, den, 1.0)
                    alpha = jnp.where(den > 0.0, alpha, 0.0)
                    x = x + alpha * p_dir
                    r = r - alpha * Sp
                    z = precond(r)
                    rz_new = dot(r, z)
                    beta = rz_new / jnp.where(rz != 0.0, rz, 1.0)
                    p_dir = z + beta * p_dir
                    return (x, r, z, p_dir, rz_new, it + 1)

                x, _, _, _, _, cg_it = jax.lax.while_loop(
                    cg_cond, cg_body, (x, r, z, p_dir, rz, jnp.asarray(0))
                )
                dc_full = jax.lax.all_gather(x, DATA_AXIS, tiled=True)
                delta_c = (dc_full * maskp)[:KC]
                delta_p = -(g_p + M @ delta_c) * inv0 / (1.0 + lam)
                return delta_c.reshape(K, C_), delta_p, cg_it

            with jax.default_matmul_precision("float32"):
                init_cost = cost_fn(prob)

                def body(state):
                    p, lam, cost, it, done, cg_tot = state
                    if camera_partition:
                        _, neq = build_part(p)
                    else:
                        _, neq = build_psum(p)

                    def apply(dc, dp):
                        new_cams = jax.vmap(cam_retract)(p.cam_states, dc)
                        return p._replace(
                            cam_states=new_cams, inv_depth=p.inv_depth + dp
                        )

                    def inner_cond(s):
                        lam_i, ok, _, tries, _, _, _ = s
                        return (~ok) & (tries < cfg.max_retries) & (
                            lam_i <= cfg.max_lambda
                        )

                    def inner_body(s):
                        lam_i, _, _, tries, _, _, cg_acc = s
                        if camera_partition:
                            dc, dp, cg_i = solve_lam_part(neq, lam_i)
                        else:
                            dc, dp = solver.solve_lam(
                                neq, plan, lam_i, free, cfg
                            )
                            cg_i = jnp.asarray(0)
                        new_cost = cost_fn(apply(dc, dp))
                        ok = (new_cost < cost) & jnp.isfinite(new_cost)
                        return (
                            jnp.where(ok, lam_i, lam_i * 10.0), ok, new_cost,
                            tries + 1, dc, dp, cg_acc + cg_i,
                        )

                    dc0 = jnp.zeros(
                        (free.shape[0], cam_tangent_dim), dtype
                    )
                    dp0 = jnp.zeros_like(p.inv_depth)
                    # accepting step's deltas ride the carry — no recompute
                    lam_f, accepted, new_cost, _, dc_f, dp_f, cg_in = (
                        jax.lax.while_loop(
                            inner_cond, inner_body,
                            (lam, False, cost, 0, dc0, dp0, jnp.asarray(0)),
                        )
                    )
                    # select only the mutable state — a whole-pytree select
                    # would copy the constant observation arrays each iter
                    p_acc = apply(dc_f, dp_f)
                    p_new = p._replace(
                        cam_states=jax.tree_util.tree_map(
                            lambda a, b: jnp.where(accepted, a, b),
                            p_acc.cam_states, p.cam_states,
                        ),
                        inv_depth=jnp.where(
                            accepted, p_acc.inv_depth, p.inv_depth
                        ),
                    )
                    cost_new = jnp.where(accepted, new_cost, cost)
                    lam_new = jnp.where(
                        accepted, jnp.maximum(lam_f / 3.0, cfg.min_lambda),
                        lam_f,
                    )
                    small = jnp.abs(cost - cost_new) <= (
                        cfg.function_tolerance * jnp.maximum(cost, 1e-300)
                    )
                    return (p_new, lam_new, cost_new, it + 1,
                            (~accepted) | small, cg_tot + cg_in)

                def cond(state):
                    _, _, _, it, done, _ = state
                    return (~done) & (it < cfg.max_iterations)

                state0 = (
                    prob, jnp.asarray(cfg.init_lambda, dtype), init_cost,
                    jnp.asarray(0), jnp.asarray(False), jnp.asarray(0),
                )
                p_f, lam, cost, iters, _, cg_tot = jax.lax.while_loop(
                    cond, body, state0
                )
            return p_f, ba.BAResult(
                cost=cost, initial_cost=init_cost, iterations=iters, lam=lam,
                cg_iterations=cg_tot,
            )

        jitted = jax.jit(run, static_argnames=())
        with mesh:
            return jitted(sharded.problem, sharded.plans)

    return solve
