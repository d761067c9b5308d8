"""Fused Schur-LM bundle-adjustment solver driven by host-precomputed plans.

Drop-in alternative to ``optim.ba.make_ba_solver`` for single-device solves:
same problem layout (``ba.BAProblem``), same LM semantics (damped trust
region with accept/reject, Huber IRLS, gauge masking), but the
normal-equation assembly uses the gather/Gram-chunk plans from
``optim.schur_plan`` instead of XLA scatter-adds, and the Schur complement
uses a dense per-landmark coupling matrix M (L, K*C) built by one-hot
camera lifting so

  * the correction  S_corr0 = M^T diag(inv_hpp) M  is ONE dense matmul
    and the back-substitution is a matvec (no irregular gathers in the hot
    loop),
  * the lambda dependence of the reduced system is analytic
    (S(lam) = H_cc + lam*diag - S_corr0 / (1 + lam)), so each LM retry costs
    one dense Cholesky of the (K*C, K*C) system instead of a rebuild,
  * with a DenseLmSchurPlan, the whole assembly is layout-conscious: 2-D
    flattened Jacobians, slot-major landmark reductions as reshapes, g_c
    as one-hot matmuls (see build_dense).

Matrix products run with precision pinned to float32 (utils/runtime): at
reduced precision the reduced system's rounding moves the solve by ~1e-2,
while pinned it matches the f64 solution to ~1e-4, like the CPU f32 path.
The optional reduced-precision S_corr0 Gram is separately validated, see
build_dense.

This replaces the Ceres SPARSE_SCHUR configuration of the reference
(include/visnav/map_utils.h:377-383) for the latency-critical single-chip
path; the scatter-based path in ``optim.ba`` remains the GSPMD-friendly
formulation used by ``parallel.dist_ba``.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from photometric_bundle_adjustment_tpu.optim import ba
from photometric_bundle_adjustment_tpu.optim.schur_plan import (  # noqa: F401
    ChunkPlan,
    DenseLmSchurPlan,
    SchurPlan,
    build_dense_lm_plan,
    build_schur_plan,
)


def plan_for_problem(problem: ba.BAProblem, host: bool | None = None,
                     **kwargs):
    """Build an assembly plan from a (host-resident) BAProblem.

    ``host=None`` (default) picks the formulation by backend: the
    entry-pair plan (``fused_host.HostSchurPlan``) on CPU, the dense
    one-hot-lifting plan (``SchurPlan``) on accelerators.  The solver
    returned by :func:`make_fused_ba_solver` dispatches on the plan type.
    """
    import numpy as np

    if host is None:
        host = jax.default_backend() == "cpu"
    if host:
        from photometric_bundle_adjustment_tpu.optim import fused_host

        return fused_host.plan_for_problem(problem, **kwargs)

    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    return build_schur_plan(
        np.asarray(problem.obs.anchor_cam),
        np.asarray(problem.obs.target_cam),
        np.asarray(problem.obs.landmark),
        K, L,
        valid=np.asarray(problem.obs.valid) != 0,
        **kwargs,
    )


def densify_problem(problem: ba.BAProblem, **kwargs):
    """Host-side reorder of a BAProblem into the slot-major landmark-dense
    layout.

    Returns ``(problem2, DenseLmSchurPlan)``: observation row ``s*L + l``
    of ``problem2`` is the s-th observation of landmark l (padding slots
    valid=0), which turns every landmark-axis reduction of the fused
    build into a reshape + dense sum over the leading slot axis (see
    DenseLmSchurPlan for why slot-major).  Camera and landmark *states*
    are untouched, so the solved problem2's ``cam_states`` / ``inv_depth``
    are directly those of the original problem; only the observation
    ordering differs.
    """
    import numpy as np

    o = problem.obs
    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    an = np.asarray(o.anchor_cam)
    tn = np.asarray(o.target_cam)
    ln = np.asarray(o.landmark)
    valid = np.asarray(o.valid)
    perm, plan = build_dense_lm_plan(
        an, tn, ln, K, L, valid=valid != 0, **kwargs
    )
    take = np.where(perm >= 0, perm, 0)
    filled = perm >= 0
    S = plan.lm_cam.shape[0]

    def reorder(x):
        return jnp.asarray(np.asarray(x)[take])

    obs2 = ba.BAObservations(
        anchor_cam=jnp.asarray(
            np.where(filled, an[take], 0).astype(np.int32)
        ),
        target_cam=jnp.asarray(
            np.where(filled, tn[take], 0).astype(np.int32)
        ),
        landmark=jnp.asarray(
            np.tile(np.arange(L), S).astype(np.int32)
        ),
        aux=jax.tree_util.tree_map(reorder, o.aux),
        valid=jnp.asarray(np.where(filled, valid[take], 0).astype(valid.dtype)),
    )
    return problem._replace(obs=obs2), plan


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
    """Returns ``solve(problem, plan, cfg) -> (problem, BAResult)``.

    Dispatches on the plan type: a ``fused_host.HostSchurPlan`` routes to
    the CPU-optimal entry-pair solver, a ``SchurPlan`` to the dense
    one-hot-lifting solver below (accelerators).  ``.build``/``.solve_lam``
    dispatch the same way.
    """
    from photometric_bundle_adjustment_tpu.optim import fused_host

    dense = _make_dense_fused_ba_solver(
        residual_fn, cam_retract, cam_tangent_dim, rj_fn=rj_fn
    )
    cell: list = []

    def _route(plan):
        if isinstance(plan, fused_host.HostSchurPlan):
            if not cell:
                cell.append(
                    fused_host.make_fused_ba_solver(
                        residual_fn, cam_retract, cam_tangent_dim, rj_fn=rj_fn
                    )
                )
            return cell[0]
        return dense

    def solve(problem: ba.BAProblem, plan, cfg: ba.BAConfig = ba.BAConfig()):
        return _route(plan)(problem, plan, cfg)

    solve.build = lambda problem, plan, cfg: _route(plan).build(
        problem, plan, cfg
    )
    solve.solve_lam = lambda neq, plan, lam, free, cfg: _route(plan).solve_lam(
        neq, plan, lam, free, cfg
    )
    return solve


def _make_dense_fused_ba_solver(
    residual_fn: Callable,
    cam_retract: Callable,
    cam_tangent_dim: int,
    rj_fn: Callable | None = None,
):
    """Returns ``solve(problem, plan, cfg) -> (problem, BAResult)``."""
    C = cam_tangent_dim
    res_cost, _ = ba.make_ba_step(residual_fn, cam_retract, C, rj_fn=rj_fn)

    def _scaled_jacobians(problem: ba.BAProblem, cfg: ba.BAConfig):
        """sqrt(Huber-weight)-scaled Jacobian rows + residuals + robust cost.

        The observation axis is padded by ONE trailing dummy row (valid=0)
        so every downstream payload carries its gather-plan zero row for
        free — plan gidx dummies already point at row O, and the padding
        avoids a cascade of full-array ``concatenate`` copies (zero-row
        concats of (O, .) payloads are full device-memory copies).
        """
        o = problem.obs
        # pad to the next multiple of 8 (>= O+1) to keep the obs axis
        # sublane-aligned; the plan's dummy index points at zero row O
        npad = 8 - (o.valid.shape[0] % 8)

        def pad1(x):
            return jnp.concatenate(
                [x, jnp.zeros((npad,) + x.shape[1:], x.dtype)]
            )

        obs_p = jax.tree_util.tree_map(pad1, o)
        cam_a = jax.tree_util.tree_map(
            lambda x: x[obs_p.anchor_cam], problem.cam_states
        )
        cam_c = jax.tree_util.tree_map(
            lambda x: x[obs_p.target_cam], problem.cam_states
        )
        rho = problem.inv_depth[obs_p.landmark]

        if rj_fn is not None:
            if getattr(rj_fn, "batched", False):
                r, J = rj_fn(cam_a, cam_c, rho, obs_p.aux)
            else:
                r, J = jax.vmap(rj_fn)(cam_a, cam_c, rho, obs_p.aux)
        else:
            def one(ca, cc_, rh, aux):
                def f(d):
                    da, dc, dr = d[:C], d[C:2 * C], d[2 * C]
                    return residual_fn(
                        cam_retract(ca, da), cam_retract(cc_, dc), rh + dr, aux
                    )

                zero = jnp.zeros((2 * C + 1,), problem.inv_depth.dtype)
                return f(zero), jax.jacfwd(f)(zero)

            r, J = jax.vmap(one)(cam_a, cam_c, rho, obs_p.aux)

        vmask = obs_p.valid[:, None] != 0
        r = jnp.where(vmask, r, 0.0)
        J = jnp.where(vmask[:, :, None], J, 0.0)
        r2 = jnp.sum(r * r, axis=-1)
        w = ba._robust_weights(r2, cfg.huber_delta) * obs_p.valid
        cost = ba._robust_cost(r2, cfg.huber_delta)
        sw = jnp.sqrt(w)
        Jsw = J * sw[:, None, None]        # (O+1, R, 2C+1), zero last row
        rsw = r * sw[:, None]              # (O+1, R)
        return cost, Jsw, rsw

    def _scaled_jacobians_flat(problem: ba.BAProblem, cfg: ba.BAConfig):
        """As ``_scaled_jacobians`` but with the Jacobian FLATTENED to 2-D
        (O+1', R*(2C+1)) — flattened inside the vmapped evaluation, so the
        3-D (O, R, 2C+1) array never materialises: small trailing dims
        are padded in tiled layouts, and every consumer would re-read that
        padding; the 2-D form pads only the single minor dim.  This is the
        layout the dense build is built around.
        """
        o = problem.obs
        npad = 8 - (o.valid.shape[0] % 8)

        def pad1(x):
            return jnp.concatenate(
                [x, jnp.zeros((npad,) + x.shape[1:], x.dtype)]
            )

        obs_p = jax.tree_util.tree_map(pad1, o)
        cam_a = jax.tree_util.tree_map(
            lambda x: x[obs_p.anchor_cam], problem.cam_states
        )
        cam_c = jax.tree_util.tree_map(
            lambda x: x[obs_p.target_cam], problem.cam_states
        )
        rho = problem.inv_depth[obs_p.landmark]

        if rj_fn is not None:
            if getattr(rj_fn, "batched", False):
                r, J = rj_fn(cam_a, cam_c, rho, obs_p.aux)
            else:
                r, J = jax.vmap(rj_fn)(cam_a, cam_c, rho, obs_p.aux)
            J2 = J.reshape(J.shape[0], -1)
        else:
            def one(ca, cc_, rh, aux):
                def f(d):
                    da, dc, dr = d[:C], d[C:2 * C], d[2 * C]
                    return residual_fn(
                        cam_retract(ca, da), cam_retract(cc_, dc), rh + dr, aux
                    )

                zero = jnp.zeros((2 * C + 1,), problem.inv_depth.dtype)
                return f(zero), jax.jacfwd(f)(zero).reshape(-1)

            r, J2 = jax.vmap(one)(cam_a, cam_c, rho, obs_p.aux)

        vmask = obs_p.valid[:, None] != 0
        r = jnp.where(vmask, r, 0.0)
        J2 = jnp.where(vmask, J2, 0.0)
        r2 = jnp.sum(r * r, axis=-1)
        w = ba._robust_weights(r2, cfg.huber_delta) * obs_p.valid
        cost = ba._robust_cost(r2, cfg.huber_delta)
        sw = jnp.sqrt(w)
        return cost, J2 * sw[:, None], r * sw[:, None]

    def build_dense(problem: ba.BAProblem, plan: DenseLmSchurPlan,
                    cfg: ba.BAConfig):
        """Normal-equation assembly for the slot-major landmark-dense
        layout — the accelerator path.

        Layout rules (see DenseLmSchurPlan): every per-observation array is
        kept 2-D with the observation axis MAJOR and a dense feature axis
        minor (J flattened to (O, R*(2C+1))); landmark reductions are
        reshapes to (S, L, width) + sums over the leading slot axis; g_c
        is two one-hot matmuls.
        """
        K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
        L = problem.inv_depth.shape[0]
        W = 2 * C + 1
        S_ = plan.lm_cam.shape[0]

        cost, J2, rsw = _scaled_jacobians_flat(problem, cfg)
        dtype = J2.dtype
        R = rsw.shape[1]                               # J2: (O+1', R*W)

        # H_cc via camera-pair Gram chunks: the 2C x 2C top-left block of
        # each chunk's Gram matrix holds [Haa Hac; Hca Hcc] for that pair.
        rows = J2[plan.pg]                             # (NCp, Bp, R*W)
        rows2 = rows.reshape(rows.shape[0], -1, W)[..., : 2 * C]
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

        # thin couplings, kept 2-D: A0 = J^T Jp (columns of J against the
        # inverse-depth column), A1 = J^T r — unrolled over the R residual
        # rows so XLA fuses one elementwise pass instead of lowering a
        # per-observation (W x R)x(R x 2) batched matmul
        Jp = jnp.stack([J2[:, r * W + 2 * C] for r in range(R)], axis=-1)
        A0 = sum(
            J2[:, r * W : (r + 1) * W] * Jp[:, r : r + 1] for r in range(R)
        )                                               # (O+1', W)
        A1 = sum(
            J2[:, r * W : (r + 1) * W] * rsw[:, r : r + 1] for r in range(R)
        )

        # landmark reductions: slot-major reshape + sum over leading axis
        A0s = A0[: S_ * L].reshape(S_, L, W)
        red0 = A0s.sum(0)                               # (L, W)
        anchor_v = red0[:, :C]
        H_pp = red0[:, 2 * C]
        g_p = A1[: S_ * L, 2 * C].reshape(S_, L).sum(0)

        # g_c and the dense per-landmark coupling M are camera-indexed
        # lifts; express them as compare+multiply+reduce instead of
        # one-hot matmuls so XLA fuses the one-hot GENERATION into the
        # reduction kernel and never writes the (O, K) / (S, L, K) lift
        # slabs to device memory (the build is bandwidth-bound exactly on
        # those materialisations).  Padding rows carry camera id K, which
        # matches no iota lane and vanishes — same as the zero one-hot row.
        iot = jnp.arange(K, dtype=jnp.int32)
        Av = A1[: S_ * L]
        man = (plan.obs_anchor_cam[:, None] == iot).astype(dtype)
        mtn = (plan.obs_target_cam[:, None] == iot).astype(dtype)
        g_c = (
            jnp.sum(man[:, :, None] * Av[:, None, :C], axis=0)
            + jnp.sum(mtn[:, :, None] * Av[:, None, C : 2 * C], axis=0)
        )                                              # (K, C)

        lm_mask = problem.lm_valid.astype(dtype)
        inv0 = lm_mask / jnp.maximum(H_pp, cfg.min_inv_depth_hessian)
        vt_sl = A0s[:, :, C : 2 * C]                    # (S, L, C)
        msk = (plan.lm_cam[:, :, None] == iot).astype(dtype)  # virt (S,L,K)
        M = jnp.sum(msk[..., None] * vt_sl[:, :, None, :], axis=0)
        amsk = (plan.anchor_cam_of_lm[:, None] == iot).astype(dtype)
        M = (M + amsk[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

        # Schur correction and rhs correction as dense matrix products.
        # The big Gram matmul optionally runs at HIGH precision (TF32 on
        # the GPU) — validated on a full 20-iteration solve to reproduce
        # the HIGHEST trajectory (identical accept/reject decisions and
        # iteration count; final pose params within 1.3e-5, inverse
        # depths within 5e-7).
        Mw = M * inv0[:, None]
        if cfg.skip_schur_gram:
            S_corr0 = None  # applied matrix-free by the partitioned solver
        else:
            prec = (jax.lax.Precision.HIGH
                    if cfg.schur_matmul_precision == "high"
                    else jax.lax.Precision.HIGHEST)
            S_corr0 = jax.lax.dot(Mw.T, M, precision=prec)  # (K*C, K*C)
        rhs_corr0 = Mw.T @ g_p      # (K*C,)

        H_cc_mat = jnp.transpose(H_cc, (0, 2, 1, 3)).reshape(K * C, K * C)
        return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)

    def build_chunk(problem: ba.BAProblem, plan: SchurPlan, cfg: ba.BAConfig):
        """Normal-equation assembly from generic chunked segment-sum plans
        (ragged observation layouts; no host reorder required)."""
        K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
        L = problem.inv_depth.shape[0]

        cost, Jsw, rsw = _scaled_jacobians(problem, cfg)
        dtype = Jsw.dtype

        rows = Jsw[plan.pg]  # (NCp, Bp, R, 2C+1); dummy slots hit zero row O
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

        # thin couplings: A[o] = Jsw[o]^T [swJp, swr] -> (O+1, 2C+1, 2)
        right = jnp.stack([Jsw[:, :, 2 * C], rsw], axis=-1)  # (O+1, R, 2)
        A = jnp.einsum("ori,ors->ois", Jsw, right)

        # landmark reductions: anchor-merged Hap, H_pp, g_p in one pass
        pay_l = jnp.concatenate(
            [A[:, :C, 0], A[:, 2 * C : 2 * C + 1, 0],
             A[:, 2 * C : 2 * C + 1, 1]],
            axis=1,
        )  # (O+1, C+2), zero last row
        red_l = _chunk_sum(pay_l, plan.lm, L)
        anchor_v, H_pp, g_p = red_l[:, :C], red_l[:, C], red_l[:, C + 1]

        # g_c: two chunked segment sums (anchor rows + target rows) — no
        # (2O, C) concatenate
        g_c = (
            _chunk_sum(A[:, :C, 1], plan.gc_a, K)
            + _chunk_sum(A[:, C : 2 * C, 1], plan.gc_t, K)
        )

        lm_mask = problem.lm_valid.astype(dtype)
        inv0 = lm_mask / jnp.maximum(H_pp, cfg.min_inv_depth_hessian)
        oh = jax.nn.one_hot(plan.lm_cam, K, dtype=dtype)
        vt = A[:, C : 2 * C, 0]  # (O+1, C) target couplings; zero last
        rows_t = vt[plan.lm.gidx]                      # (NC, B, C)
        part = jnp.einsum("nbk,nbc->nkc", oh, rows_t)  # (NC, K, C)
        M = (
            jnp.zeros((L + 1, K * C), dtype)
            .at[plan.lm.rows]
            .add(part.reshape(part.shape[0], K * C))[:L]
        )
        oh_a = jax.nn.one_hot(plan.anchor_cam_of_lm, K, dtype=dtype)  # (L, K)
        M = M + (oh_a[:, :, None] * anchor_v[:, None, :]).reshape(L, K * C)

        # Schur correction and rhs correction as dense matrix products
        Mw = M * inv0[:, None]
        S_corr0 = None if cfg.skip_schur_gram else Mw.T @ M  # (K*C, K*C)
        rhs_corr0 = Mw.T @ g_p      # (K*C,)

        H_cc_mat = jnp.transpose(H_cc, (0, 2, 1, 3)).reshape(K * C, K * C)
        return cost, (H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0)

    def build(problem: ba.BAProblem, plan, cfg: ba.BAConfig):
        """One normal-equation assembly; everything lambda-independent."""
        if isinstance(plan, DenseLmSchurPlan):
            return build_dense(problem, plan, cfg)
        return build_chunk(problem, plan, cfg)

    def solve_lam(neq, plan: SchurPlan, lam, free_cam_mask, cfg: ba.BAConfig):
        """Per-lambda dense solve + back-substitution (cheap retry)."""
        H_cc_mat, S_corr0, rhs_corr0, H_pp, g_c, g_p, M, inv0 = neq
        KC = H_cc_mat.shape[0]
        K = free_cam_mask.shape[0]
        C_ = KC // K
        dtype = g_c.dtype
        d_cc = jnp.clip(jnp.diagonal(H_cc_mat), 1e-12, 1e32)
        S = H_cc_mat + jnp.diag(lam * d_cc) - S_corr0 / (1.0 + lam)
        rhs = -(g_c.reshape(-1) - rhs_corr0 / (1.0 + lam))
        mask = jnp.repeat(free_cam_mask.astype(dtype), C_)
        S = S * mask[:, None] * mask[None, :] + jnp.diag(1.0 - mask)
        cho = jax.scipy.linalg.cho_factor(S, lower=True)
        delta_c = jax.scipy.linalg.cho_solve(cho, rhs * mask) * mask

        delta_p = -(g_p + M @ delta_c) * inv0 / (1.0 + lam)
        return delta_c.reshape(K, C_), delta_p

    def apply_step(problem: ba.BAProblem, delta_c, delta_p):
        new_cams = jax.vmap(cam_retract)(problem.cam_states, delta_c)
        return problem._replace(
            cam_states=new_cams, inv_depth=problem.inv_depth + delta_p
        )

    def _select_states(flag, p_a, p_b):
        """Problem with p_a's mutable state where flag, else p_b's — never
        selects (copies) the constant observation arrays."""
        return p_b._replace(
            cam_states=jax.tree_util.tree_map(
                lambda a, b: jnp.where(flag, a, b),
                p_a.cam_states, p_b.cam_states,
            ),
            inv_depth=jnp.where(flag, p_a.inv_depth, p_b.inv_depth),
        )

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def solve_cost_from_build(problem: ba.BAProblem, plan,
                              cfg: ba.BAConfig = ba.BAConfig()):
        """Fused-cost LM loop: one while_loop over TRIES; each try solves
        the damped system from the carried normal equations, then builds
        at the trial point — the build's robust cost is the accept/reject
        check AND, on acceptance, its normal equations seed the next
        iteration.  No separate residual pass ever runs (for photometric
        BA that pass re-samples every patch).

        Same accept criterion, lambda schedule (x10 per reject, /3 on
        accept), termination (max_retries consecutive rejects, lambda cap,
        function tolerance) and gauge handling as the classic loop; a
        rejected try costs a full build instead of a residual pass, so
        this is opt-in via cfg.cost_from_build.
        """
        with jax.default_matmul_precision("float32"):
            free = ~problem.fixed_cams
            dtype = problem.inv_depth.dtype
            init_cost, neq0 = build(problem, plan, cfg)

            def body(state):
                prob, lam, cost, neq, rejects, iters, tries, done = state
                dc, dp = solve_lam(neq, plan, lam, free, cfg)
                p_try = apply_step(prob, dc, dp)
                cost_try, neq_try = build(p_try, plan, cfg)
                ok = (cost_try < cost) & jnp.isfinite(cost_try)
                p_new = _select_states(ok, p_try, prob)
                neq_new = jax.tree_util.tree_map(
                    lambda a, b: jnp.where(ok, a, b), neq_try, neq
                )
                cost_new = jnp.where(ok, cost_try, cost)
                lam_new = jnp.where(
                    ok, jnp.maximum(lam / 3.0, cfg.min_lambda), lam * 10.0
                )
                rejects_new = jnp.where(ok, 0, rejects + 1)
                small = ok & (
                    jnp.abs(cost - cost_try)
                    <= cfg.function_tolerance * jnp.maximum(cost, 1e-300)
                )
                done_new = small | (rejects_new >= cfg.max_retries) | (
                    lam_new > cfg.max_lambda
                )
                return (p_new, lam_new, cost_new, neq_new, rejects_new,
                        iters + ok.astype(jnp.int32), tries + 1, done_new)

            def cond(state):
                _, _, _, _, _, iters, tries, done = state
                return (~done) & (iters < cfg.max_iterations) & (
                    tries < cfg.max_iterations * cfg.max_retries
                )

            state0 = (
                problem, jnp.asarray(cfg.init_lambda, dtype), init_cost,
                neq0, jnp.asarray(0), jnp.asarray(0), jnp.asarray(0),
                jnp.asarray(False),
            )
            prob, lam, cost, _, _, iters, _, _ = jax.lax.while_loop(
                cond, body, state0
            )
            return prob, ba.BAResult(
                cost=cost, initial_cost=init_cost, iterations=iters, lam=lam
            )

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def solve_classic(problem: ba.BAProblem, plan: SchurPlan,
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
                    p_try = apply_step(prob, dc, dp)
                    new_cost = res_cost(p_try, cfg)
                    ok = (new_cost < cost) & jnp.isfinite(new_cost)
                    return (
                        jnp.where(ok, lam_i, lam_i * 10.0), ok, new_cost,
                        tries + 1, dc, dp,
                    )

                K_ = free.shape[0]
                dc0 = jnp.zeros((K_, C), prob.inv_depth.dtype)
                dp0 = jnp.zeros_like(prob.inv_depth)
                # the accepting step's deltas ride the carry — no recompute
                lam_f, accepted, new_cost, _, dc_f, dp_f = jax.lax.while_loop(
                    inner_cond, inner_body, (lam, False, cost, 0, dc0, dp0)
                )
                # select only the mutable state — a whole-pytree select
                # would copy the (large, constant) observation arrays every
                # iteration
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

    def solve(problem: ba.BAProblem, plan,
              cfg: ba.BAConfig = ba.BAConfig()):
        if cfg.cost_from_build:
            return solve_cost_from_build(problem, plan, cfg)
        return solve_classic(problem, plan, cfg)

    # expose the pieces for benchmarking / custom loops
    solve.build = build
    solve.solve_lam = solve_lam
    return solve
