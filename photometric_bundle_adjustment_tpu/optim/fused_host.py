"""Host-CPU fused Schur-LM solver: entry-pair camera-pair-space assembly.

The entry-pair formulation assembles the Schur correction from per-landmark
entry pairs with chunked gathers — the fastest formulation on host CPU
(measured ~115 ms/LM-iteration at 200 cams / 8k landmarks / 49k obs vs
~297 ms for the scatter path and ~338 ms for the dense one-hot matmul
formulation of ``optim.fused`` that the accelerators take).  ``optim.fused``
dispatches here automatically when the default backend is CPU.

Same API shape as ``optim.fused``: ``plan_for_problem`` ->
``HostSchurPlan``; ``make_fused_ba_solver(...)`` -> solve with ``.build``
and ``.solve_lam`` attributes.  Replaces the Ceres SPARSE_SCHUR
configuration of the reference (include/visnav/map_utils.h:377-383) for
host execution.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.optim import ba
from photometric_bundle_adjustment_tpu.optim.schur_plan import (
    ChunkPlan,
    _build_chunk_plan,
    _chunk_segments,
    _round_up,
)

class HostSchurPlan(NamedTuple):
    """Full assembly plan for one BA problem's observation graph."""

    # camera-pair Gram chunks for H_cc
    pg: np.ndarray        # (NCp, Bp) int32 obs ids [0, O]; O = zero Js row
    cc_rows4: np.ndarray  # (NCp, 4) int32 rows into (K*K [+1 dropped], .)
    # landmark segment sums (anchor merge, H_pp, g_p, back-substitution)
    lm: ChunkPlan         # payload rows: obs ids [0, O] -> L rows
    # camera segment sums for g_c
    gc: ChunkPlan         # payload rows: [anchor obs; target obs] [0, 2O] -> K
    # Schur-correction entry pairs (strict upper triangle per landmark)
    pr_e1: np.ndarray     # (NCpr, Bpr) int32 entry ids [0, NE]; NE = zero row
    pr_e2: np.ndarray     # (NCpr, Bpr)
    pr_rows: np.ndarray   # (NCpr,) int32 rows into (K*K [+1 dropped], .)
    # diagonal entry pairs and rhs correction
    dg: ChunkPlan         # payload rows: entry ids [0, NE] -> K*K rows
    ec: ChunkPlan         # payload rows: entry ids [0, NE] -> K rows
    entry_cam: np.ndarray  # (NE,) int32
    entry_lm: np.ndarray   # (NE,) int32



def build_host_schur_plan(
    anchor_cam,
    target_cam,
    landmark,
    K: int,
    L: int,
    valid=None,
    *,
    pair_chunk: int = 32,
    lm_chunk: int = 8,
    cam_chunk: int = 256,
    entry_pair_chunk: int = 32,
    nc_bucket: int = 64,
    pow2_buckets: bool = True,
    max_entry_pairs: int | None = None,
) -> HostSchurPlan:
    """Build the assembly plan on the host from the observation graph.

    Invalid (padding) observations are excluded from every plan — their
    payload is zero anyway, and excluding them keeps the entry-pair
    expansion from exploding when padding aliases one landmark index.

    ``max_entry_pairs`` guards against pathological covisibility (a landmark
    observed by very many cameras makes the per-landmark pair expansion
    quadratic); raises ValueError when exceeded so callers can fall back to
    the scatter-based assembly.
    """
    an = np.asarray(anchor_cam, np.int64)
    tn = np.asarray(target_cam, np.int64)
    ln = np.asarray(landmark, np.int64)
    O = an.shape[0]
    if valid is None:
        vmask = np.ones(O, bool)
    else:
        vmask = np.asarray(valid).astype(bool)
    vidx = np.flatnonzero(vmask)

    # ---- camera-pair Gram chunks for H_cc --------------------------------
    pair_ids = an[vidx] * K + tn[vidx]
    gidx, prows = _chunk_segments(pair_ids, pair_chunk)
    # map chunk-local gather slots back to original obs ids
    gidx = np.where(gidx >= 0, vidx[np.clip(gidx, 0, None)], O)
    NCp = gidx.shape[0]
    NCpb = _round_up(NCp, nc_bucket, pow2_buckets)
    pg = np.full((NCpb, pair_chunk), O, np.int64)
    pg[:NCp] = gidx
    pa, pc = prows // K, prows % K
    rows4 = np.stack([pa * K + pa, pa * K + pc, pc * K + pa, pc * K + pc], 1)
    cc_rows4 = np.full((NCpb, 4), K * K, np.int64)
    cc_rows4[:NCp] = rows4

    # ---- landmark chunks (payload = obs rows, valid only) -----------------
    g2, r2 = _chunk_segments(ln[vidx], lm_chunk)
    g2 = np.where(g2 >= 0, vidx[np.clip(g2, 0, None)], O)
    NC2 = g2.shape[0]
    NC2b = _round_up(NC2, nc_bucket, pow2_buckets)
    lg = np.full((NC2b, lm_chunk), O, np.int64)
    lg[:NC2] = g2
    lr = np.full(NC2b, L, np.int64)
    lr[:NC2] = r2
    lm_plan = ChunkPlan(lg.astype(np.int32), lr.astype(np.int32))

    # ---- camera chunks for g_c (payload = [anchor rows; target rows]) ----
    gc_ids = np.concatenate([an[vidx], tn[vidx]])
    gc_src = np.concatenate([vidx, vidx + O])
    g3, r3 = _chunk_segments(gc_ids, cam_chunk)
    g3 = np.where(g3 >= 0, gc_src[np.clip(g3, 0, None)], 2 * O)
    NC3 = g3.shape[0]
    NC3b = _round_up(NC3, nc_bucket, pow2_buckets)
    gg = np.full((NC3b, cam_chunk), 2 * O, np.int64)
    gg[:NC3] = g3
    gr = np.full(NC3b, K, np.int64)
    gr[:NC3] = r3
    gc_plan = ChunkPlan(gg.astype(np.int32), gr.astype(np.int32))

    # ---- entries: L anchors + O targets ----------------------------------
    NE = L + O
    anchor_cam_of_lm = np.zeros(L, np.int64)
    # first valid obs of each landmark defines its anchor camera
    order = np.argsort(ln[vidx], kind="stable")
    lv = ln[vidx][order]
    firsts = np.flatnonzero(np.r_[True, lv[1:] != lv[:-1]])
    anchor_cam_of_lm[lv[firsts]] = an[vidx][order][firsts]
    entry_cam = np.concatenate([anchor_cam_of_lm, tn])
    entry_lm = np.concatenate([np.arange(L), ln])

    # per-landmark entry lists: anchor entry l, then target entries L + obs
    # sorted by landmark.  Sizes m_l = 1 + n_l (valid obs only).
    sorted_obs = vidx[order]                       # obs ids grouped by lm
    lms_present = lv[firsts]
    seg_len = np.r_[firsts[1:], lv.shape[0]] - firsts
    m = seg_len + 1                                # entries per landmark
    n_pairs = m * (m - 1) // 2
    NP = int(n_pairs.sum())
    if max_entry_pairs is not None and NP > max_entry_pairs:
        raise ValueError(
            f"entry-pair expansion too large ({NP} > {max_entry_pairs})"
        )

    # vectorised strict-upper pair expansion grouped by segment size
    pe1_parts, pe2_parts = [], []
    for sz in np.unique(m):
        sel = np.flatnonzero(m == sz)
        if sz < 2:
            continue
        iu, ju = np.triu_indices(int(sz), k=1)
        # entry table per segment: [anchor, targets...]
        ent = np.empty((sel.shape[0], int(sz)), np.int64)
        ent[:, 0] = lms_present[sel]
        starts = firsts[sel]
        offs = np.arange(int(sz) - 1)
        ent[:, 1:] = L + sorted_obs[starts[:, None] + offs[None, :]]
        pe1_parts.append(ent[:, iu].ravel())
        pe2_parts.append(ent[:, ju].ravel())
    if pe1_parts:
        pe1 = np.concatenate(pe1_parts)
        pe2 = np.concatenate(pe2_parts)
    else:
        pe1 = np.zeros(0, np.int64)
        pe2 = np.zeros(0, np.int64)

    pr_ids = entry_cam[pe1] * K + entry_cam[pe2]
    g4, r4 = _chunk_segments(pr_ids, entry_pair_chunk)
    NP_tot = pe1.shape[0]
    pe1_pad = np.r_[pe1, NE]
    pe2_pad = np.r_[pe2, NE]
    g4 = np.where(g4 >= 0, g4, NP_tot)
    NC4 = g4.shape[0]
    NC4b = _round_up(NC4, nc_bucket, pow2_buckets)
    pr_e1 = np.full((NC4b, entry_pair_chunk), NE, np.int64)
    pr_e2 = np.full((NC4b, entry_pair_chunk), NE, np.int64)
    pr_e1[:NC4] = pe1_pad[g4]
    pr_e2[:NC4] = pe2_pad[g4]
    pr_rows = np.full(NC4b, K * K, np.int64)
    pr_rows[:NC4] = r4

    # diagonal entry pairs + rhs correction: over valid entries only
    # (anchor entries of landmarks with no valid obs have zero value anyway)
    dg_plan = _build_chunk_plan(entry_cam * K + entry_cam, cam_chunk,
                                NE, K * K, nc_bucket, pow2_buckets)
    ec_plan = _build_chunk_plan(entry_cam, cam_chunk, NE, K, nc_bucket,
                                pow2_buckets)

    return HostSchurPlan(
        pg=pg.astype(np.int32),
        cc_rows4=cc_rows4.astype(np.int32),
        lm=lm_plan,
        gc=gc_plan,
        pr_e1=pr_e1.astype(np.int32),
        pr_e2=pr_e2.astype(np.int32),
        pr_rows=pr_rows.astype(np.int32),
        dg=dg_plan,
        ec=ec_plan,
        entry_cam=entry_cam.astype(np.int32),
        entry_lm=entry_lm.astype(np.int32),
    )



def plan_for_problem(problem: ba.BAProblem, **kwargs) -> HostSchurPlan:
    """Build a HostSchurPlan from a (host-resident) BAProblem."""
    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    return build_host_schur_plan(
        np.asarray(problem.obs.anchor_cam),
        np.asarray(problem.obs.target_cam),
        np.asarray(problem.obs.landmark),
        K, L,
        valid=np.asarray(problem.obs.valid) != 0,
        **kwargs,
    )


def _chunk_sum(payload, plan: ChunkPlan, n_rows: int):
    """payload (N+1, D) with zero last row -> (n_rows, D)."""
    partial = payload[plan.gidx].sum(axis=1)  # (NC, D)
    out = jnp.zeros((n_rows + 1, payload.shape[1]), payload.dtype)
    return out.at[plan.rows].add(partial)[:n_rows]


def make_fused_ba_solver(
    residual_fn: Callable,
    cam_retract: Callable,
    cam_tangent_dim: int,
    rj_fn: Callable | None = None,
):
    """Returns ``solve(problem, plan, cfg) -> (problem, BAResult)``."""
    C = cam_tangent_dim
    res_cost, _ = ba.make_ba_step(residual_fn, cam_retract, C, rj_fn=rj_fn)

    def _scaled_jacobians(problem: ba.BAProblem, cfg: ba.BAConfig):
        """sqrt(Huber-weight)-scaled [Ja Jc Jp r] rows + robust cost."""
        o = problem.obs
        cam_a = jax.tree_util.tree_map(lambda x: x[o.anchor_cam], problem.cam_states)
        cam_c = jax.tree_util.tree_map(lambda x: x[o.target_cam], problem.cam_states)
        rho = problem.inv_depth[o.landmark]

        if rj_fn is not None:
            r, J = jax.vmap(rj_fn)(cam_a, cam_c, rho, o.aux)
        else:
            def one(ca, cc_, rh, aux):
                def f(d):
                    da, dc, dr = d[:C], d[C:2 * C], d[2 * C]
                    return residual_fn(
                        cam_retract(ca, da), cam_retract(cc_, dc), rh + dr, aux
                    )

                zero = jnp.zeros((2 * C + 1,), problem.inv_depth.dtype)
                return f(zero), jax.jacfwd(f)(zero)

            r, J = jax.vmap(one)(cam_a, cam_c, rho, o.aux)

        vmask = o.valid[:, None] != 0
        r = jnp.where(vmask, r, 0.0)
        J = jnp.where(vmask[:, :, None], J, 0.0)
        r2 = jnp.sum(r * r, axis=-1)
        w = ba._robust_weights(r2, cfg.huber_delta) * o.valid
        cost = ba._robust_cost(r2, cfg.huber_delta)
        sw = jnp.sqrt(w)
        Js = jnp.concatenate([J, r[:, :, None]], axis=-1) * sw[:, None, None]
        return cost, Js  # Js: (O, R, 2C+2)

    def build(problem: ba.BAProblem, plan: HostSchurPlan, cfg: ba.BAConfig):
        """One normal-equation assembly; everything lambda-independent."""
        K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
        L = problem.inv_depth.shape[0]
        o = problem.obs
        O = o.valid.shape[0]
        D = 2 * C + 2

        cost, Js = _scaled_jacobians(problem, cfg)
        dtype = Js.dtype

        # H_cc via camera-pair Gram chunks: the 2C x 2C top-left block of
        # each chunk's Gram matrix holds [Haa Hac; Hca Hcc] for that pair.
        Jpad = jnp.concatenate([Js, jnp.zeros((1,) + Js.shape[1:], dtype)])
        rows = Jpad[plan.pg]  # (NCp, Bp, R, D)
        rows2 = rows[..., : 2 * C].reshape(rows.shape[0], -1, 2 * C)
        G2 = jnp.einsum("nbi,nbj->nij", rows2, rows2)  # (NCp, 2C, 2C)
        blocks = jnp.stack(
            [G2[:, :C, :C], G2[:, :C, C:], G2[:, C:, :C], G2[:, C:, C:]],
            axis=1,
        ).reshape(-1, C * C)  # (NCp*4, C*C)
        H_cc = (
            jnp.zeros((K * K + 1, C * C), dtype)
            .at[plan.cc_rows4.reshape(-1)]
            .add(blocks)[: K * K]
            .reshape(K, K, C, C)
        )

        # thin couplings: A[o] = Js[o]^T [swJp, swr] -> (O, D, 2)
        right = Js[:, :, 2 * C :]  # (O, R, 2)
        A = jnp.einsum("ori,ors->ois", Js, right)

        # landmark reductions: anchor-merged Hap, H_pp, g_p in one pass
        pay_l = jnp.concatenate(
            [A[:, :C, 0], A[:, 2 * C : 2 * C + 1, 0], A[:, 2 * C : 2 * C + 1, 1]],
            axis=1,
        )  # (O, C+2)
        pay_l = jnp.concatenate([pay_l, jnp.zeros((1, C + 2), dtype)])
        red_l = _chunk_sum(pay_l, plan.lm, L)
        anchor_v, H_pp, g_p = red_l[:, :C], red_l[:, C], red_l[:, C + 1]

        # g_c
        pay_gc = jnp.concatenate([A[:, :C, 1], A[:, C : 2 * C, 1]])
        pay_gc = jnp.concatenate([pay_gc, jnp.zeros((1, C), dtype)])
        g_c = _chunk_sum(pay_gc, plan.gc, K)

        # Schur correction in camera-pair space
        lm_mask = problem.lm_valid.astype(dtype)
        inv0 = lm_mask / jnp.maximum(H_pp, cfg.min_inv_depth_hessian)
        v = jnp.concatenate(
            [anchor_v, A[:, C : 2 * C, 0], jnp.zeros((1, C), dtype)]
        )  # (NE+1, C); target couplings Hcp per obs
        ew = jnp.concatenate([inv0[plan.entry_lm], jnp.zeros((1,), dtype)])
        w1 = v * ew[:, None]
        r1 = w1[plan.pr_e1]  # (NCpr, Bpr, C)
        r2_ = v[plan.pr_e2]
        Gp = jnp.einsum("nbi,nbj->nij", r1, r2_).reshape(-1, C * C)
        U = (
            jnp.zeros((K * K + 1, C * C), dtype)
            .at[plan.pr_rows]
            .add(Gp)[: K * K]
            .reshape(K, K, C, C)
        )
        vv, wd = v[:-1], w1[:-1]
        pay_dg = (wd[:, :, None] * vv[:, None, :]).reshape(-1, C * C)
        pay_dg = jnp.concatenate([pay_dg, jnp.zeros((1, C * C), dtype)])
        Dg = _chunk_sum(pay_dg, plan.dg, K * K).reshape(K, K, C, C)
        S_corr0 = U + jnp.transpose(U, (1, 0, 3, 2)) + Dg

        # rhs correction sum_l inv0_l g_p_l c_l
        pay_rc = wd * g_p[plan.entry_lm][:, None]
        pay_rc = jnp.concatenate([pay_rc, jnp.zeros((1, C), dtype)])
        rhs_corr0 = _chunk_sum(pay_rc, plan.ec, K)

        return cost, (H_cc, S_corr0, rhs_corr0, H_pp, g_c, g_p, v, inv0)

    def solve_lam(neq, plan: HostSchurPlan, lam, free_cam_mask, cfg: ba.BAConfig):
        """Per-lambda dense solve + back-substitution (cheap retry)."""
        H_cc, S_corr0, rhs_corr0, H_pp, g_c, g_p, v, inv0 = neq
        K, _, C_, _ = H_cc.shape
        L = H_pp.shape[0]
        dtype = g_c.dtype
        H_cc_mat = jnp.transpose(H_cc, (0, 2, 1, 3)).reshape(K * C_, K * C_)
        S0_mat = jnp.transpose(S_corr0, (0, 2, 1, 3)).reshape(K * C_, K * C_)
        d_cc = jnp.clip(jnp.diagonal(H_cc_mat), 1e-12, 1e32)
        S = H_cc_mat + jnp.diag(lam * d_cc) - S0_mat / (1.0 + lam)
        rhs = -(g_c.reshape(-1) - rhs_corr0.reshape(-1) / (1.0 + lam))
        mask = jnp.repeat(free_cam_mask.astype(dtype), C_)
        S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        cho = jax.scipy.linalg.cho_factor(S, lower=True)
        delta_c = jax.scipy.linalg.cho_solve(cho, rhs * mask) * mask

        dc_mat = delta_c.reshape(K, C_)
        dot_e = jnp.sum(v[:-1] * dc_mat[plan.entry_cam], axis=-1)  # (NE,)
        anchor_part = dot_e[:L]
        pay = jnp.concatenate([dot_e[L:, None], jnp.zeros((1, 1), dtype)])
        target_part = _chunk_sum(pay, plan.lm, L)[:, 0]
        delta_p = -(g_p + anchor_part + target_part) * inv0 / (1.0 + lam)
        return dc_mat, delta_p

    def apply_step(problem: ba.BAProblem, delta_c, delta_p):
        new_cams = jax.vmap(cam_retract)(problem.cam_states, delta_c)
        return problem._replace(
            cam_states=new_cams, inv_depth=problem.inv_depth + delta_p
        )

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def solve(problem: ba.BAProblem, plan: HostSchurPlan,
              cfg: ba.BAConfig = ba.BAConfig()):
        with jax.default_matmul_precision("float32"):
            free = ~problem.fixed_cams
            init_cost = res_cost(problem, cfg)
            dtype = problem.inv_depth.dtype

            def body(state):
                prob, lam, cost, it, done = state
                _, neq = build(prob, plan, cfg)

                def inner_cond(s):
                    lam_i, ok, _, tries, _, _ = s
                    return (~ok) & (tries < cfg.max_retries) & (
                        lam_i <= cfg.max_lambda
                    )

                def inner_body(s):
                    lam_i, _, _, tries, _, _ = s
                    dc, dp = solve_lam(neq, plan, lam_i, free, cfg)
                    new_cost = res_cost(apply_step(prob, dc, dp), cfg)
                    ok = (new_cost < cost) & jnp.isfinite(new_cost)
                    return (
                        jnp.where(ok, lam_i, lam_i * 10.0), ok, new_cost,
                        tries + 1, dc, dp,
                    )

                dc0 = jnp.zeros((free.shape[0], C), dtype)
                dp0 = jnp.zeros_like(prob.inv_depth)
                # the accepting step's deltas ride the carry — no recompute
                lam_f, accepted, new_cost, _, dc_f, dp_f = jax.lax.while_loop(
                    inner_cond, inner_body, (lam, False, cost, 0, dc0, dp0)
                )
                # select only the mutable state — a whole-pytree select
                # would copy the constant observation arrays each iteration
                p_acc = apply_step(prob, dc_f, dp_f)
                p_new = prob._replace(
                    cam_states=jax.tree_util.tree_map(
                        lambda a, b: jnp.where(accepted, a, b),
                        p_acc.cam_states, prob.cam_states,
                    ),
                    inv_depth=jnp.where(
                        accepted, p_acc.inv_depth, prob.inv_depth
                    ),
                )
                cost_new = jnp.where(accepted, new_cost, cost)
                lam_new = jnp.where(
                    accepted, jnp.maximum(lam_f / 3.0, cfg.min_lambda), lam_f
                )
                small = jnp.abs(cost - cost_new) <= (
                    cfg.function_tolerance * jnp.maximum(cost, 1e-300)
                )
                done_new = (~accepted) | small
                return (p_new, lam_new, cost_new, it + 1, done_new)

            def cond(state):
                _, _, _, it, done = state
                return (~done) & (it < cfg.max_iterations)

            state0 = (
                problem,
                jnp.asarray(cfg.init_lambda, dtype),
                init_cost,
                jnp.asarray(0),
                jnp.asarray(False),
            )
            prob, lam, cost, iters, _ = jax.lax.while_loop(cond, body, state0)
            return prob, ba.BAResult(
                cost=cost, initial_cost=init_cost, iterations=iters, lam=lam
            )

    # expose the pieces for benchmarking / custom loops
    solve.build = build
    solve.solve_lam = solve_lam
    return solve
