"""Schur-complement bundle-adjustment solver (the SPARSE_SCHUR replacement).

Batched re-design of the reference's Ceres BA configuration
(include/visnav/map_utils.h:322-399: AutoDiffCostFunction<...,2,7,7,1,8>,
HuberLoss, SPARSE_SCHUR, landmark blocks of dimension **1** because landmarks
are anchored inverse depths).  Instead of a block-sparse matrix + generic
sparse Schur elimination, the problem is laid out as struct-of-arrays with
static shapes:

  * camera states: pytree with leading dim ``K`` (poses ``(K, 7)``, plus
    optional extras such as affine-brightness parameters for photometric BA),
    with a per-camera tangent dimension ``C`` (static),
  * landmarks: inverse depths ``(L,)`` — scalar blocks,
  * observations: flat COO arrays over ``O`` with (anchor camera index,
    target camera index, landmark index, per-obs auxiliary data, validity
    mask for padding).

Per-observation residuals+Jacobians are evaluated by one ``vmap``-ed
``jacfwd`` (manual-free, still a single fused XLA kernel); the normal
equations are assembled with scatter-adds; the Schur complement

    S = H_cc - H_cp diag(H_pp)^-1 H_pc

is ONE dense matmul over the landmark axis — exactly the shape matrix
units want — and the reduced camera system (``6K x 6K`` with K at most a few
hundred) is solved by dense Cholesky on-chip.  The landmark axis is the
data-parallel axis for multi-chip sharding (see
``photometric_bundle_adjustment_tpu.parallel``): each device computes the
partial S/rhs over its landmark shard and the solver only needs a ``psum``
of the small reduced system.

The damped LM loop (accept/reject with lambda adaptation, Huber IRLS
weighting) runs inside ``lax.while_loop`` so an entire 20-iteration solve
(map_utils.h:318) is one XLA computation.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class BAObservations(NamedTuple):
    """Flat observation table (static shapes; pad + mask for dynamics)."""

    anchor_cam: jax.Array  # (O,) int32 — camera index of the landmark's anchor
    target_cam: jax.Array  # (O,) int32 — camera index of this observation
    landmark: jax.Array    # (O,) int32 — landmark index
    aux: tuple             # pytree of (O, ...) per-obs constants (pixels, intrinsics)
    valid: jax.Array       # (O,) bool


class BAProblem(NamedTuple):
    cam_states: tuple      # pytree, leaves (K, ...)
    inv_depth: jax.Array   # (L,)
    obs: BAObservations
    fixed_cams: jax.Array  # (K,) bool — gauge fixing (sfm.cpp:1903)
    lm_valid: jax.Array    # (L,) bool — padding landmarks


class BAConfig(NamedTuple):
    max_iterations: int = 20          # map_utils.h:318
    huber_delta: float = 1.0          # pixels (sfm.cpp:244-245); <=0 => squared loss
    init_lambda: float = 1e-4
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    function_tolerance: float = 1e-10
    max_retries: int = 6              # lambda escalations per iteration
    min_inv_depth_hessian: float = 1e-12
    # precision of the Schur-correction Gram matmul S_corr0 = Mw^T M in the
    # fused dense build ("highest" = full f32, "high" = TF32 on the GPU).
    # Everything else stays pinned at float32/HIGHEST.
    schur_matmul_precision: str = "highest"
    # skip the dense S_corr0 = Mw^T M Gram matmul in the fused builds: the
    # camera-partitioned distributed solve (parallel.dist_fused) applies
    # the Schur correction matrix-free inside CG and never needs the
    # materialised (KC x KC) product — at large K the Gram matmul is the
    # dominant build cost, so the partitioned path must not pay it.
    skip_schur_gram: bool = False
    # fused-cost LM loop (optim.fused only): evaluate each trial point with
    # a FULL normal-equation build instead of a separate residual pass —
    # the build's cost doubles as the accept/reject check and its normal
    # equations are reused for the next iteration on acceptance.  Wins
    # when residual evaluation is a large fraction of a build (photometric
    # BA: the residual re-samples every patch); loses on retry-heavy
    # problems (a rejected try costs a full build).
    cost_from_build: bool = False


class BAResult(NamedTuple):
    cost: jax.Array
    initial_cost: jax.Array
    iterations: jax.Array
    lam: jax.Array
    # total inner-CG iterations across the solve (0 where the path solves
    # the reduced system directly; populated by the camera-partitioned
    # matrix-free PCG in parallel.dist_fused)
    cg_iterations: jax.Array | int = 0


def _robust_weights(r2: jax.Array, delta: float) -> jax.Array:
    """Huber rho'(s) on squared block norms (Ceres HuberLoss semantics)."""
    if delta <= 0:
        return jnp.ones_like(r2)
    sqrt_s = jnp.sqrt(jnp.maximum(r2, 1e-300))
    return jnp.where(r2 <= delta * delta, jnp.ones_like(r2), delta / sqrt_s)


def _robust_cost(r2: jax.Array, delta: float) -> jax.Array:
    if delta <= 0:
        return 0.5 * jnp.sum(r2)
    sqrt_s = jnp.sqrt(jnp.maximum(r2, 1e-300))
    rho = jnp.where(r2 <= delta * delta, r2, 2.0 * delta * sqrt_s - delta * delta)
    return 0.5 * jnp.sum(rho)


def make_ba_step(
    residual_fn: Callable,
    cam_retract: Callable,
    cam_tangent_dim: int,
    rj_fn: Callable | None = None,
):
    """Build the residual/Jacobian/assembly machinery for a BA problem family.

    Args:
      residual_fn: ``(cam_state_a, cam_state_c, rho, aux) -> (R,)`` residual
        for a single observation; ``cam_state_*`` are single-camera slices of
        the camera pytree.  This is the analog of
        BundleAdjustmentReprojectionCostFunctor (reprojection.h:74-118).
      cam_retract: ``(cam_state, delta (C,)) -> cam_state`` manifold update.
      cam_tangent_dim: C (static).
      rj_fn: optional hand-derived ``(cam_a, cam_c, rho, aux) -> (r (R,),
        J (R, 2C+1))`` replacing the jacfwd-through-retraction default (the
        default runs 2C+1 forward-mode passes; closed-form chain-rule
        Jacobians cut that to the cost of ~one).

    Returns (residuals_and_cost, build_normal_eqs) closures.
    """
    C = cam_tangent_dim

    def _obs_r(problem: BAProblem, o: BAObservations):
        cam_a = jax.tree_util.tree_map(lambda x: x[o.anchor_cam], problem.cam_states)
        cam_c = jax.tree_util.tree_map(lambda x: x[o.target_cam], problem.cam_states)
        rho = problem.inv_depth[o.landmark]

        if getattr(residual_fn, "batched", False):
            return residual_fn(cam_a, cam_c, rho, o.aux)

        def one(ca, cc, rh, aux):
            return residual_fn(ca, cc, rh, aux)

        return jax.vmap(one)(cam_a, cam_c, rho, o.aux)

    def residual_cost(problem: BAProblem, cfg: BAConfig):
        r = _obs_r(problem, problem.obs)  # (O, R)
        # mask via where (not multiply) so NaN/Inf residuals from padding
        # observations with arbitrary aux content cannot poison the cost
        r = jnp.where(problem.obs.valid[:, None] != 0, r, 0.0)
        r2 = jnp.sum(r * r, axis=-1)
        return _robust_cost(r2, cfg.huber_delta)

    def _obs_r_and_J(problem: BAProblem):
        o = problem.obs
        cam_a = jax.tree_util.tree_map(lambda x: x[o.anchor_cam], problem.cam_states)
        cam_c = jax.tree_util.tree_map(lambda x: x[o.target_cam], problem.cam_states)
        rho = problem.inv_depth[o.landmark]

        if rj_fn is not None:
            if getattr(rj_fn, "batched", False):
                return rj_fn(cam_a, cam_c, rho, o.aux)
            return jax.vmap(rj_fn)(cam_a, cam_c, rho, o.aux)

        def one(ca, cc, rh, aux):
            def f(d):
                da, dc, dr = d[:C], d[C : 2 * C], d[2 * C]
                return residual_fn(
                    cam_retract(ca, da), cam_retract(cc, dc), rh + dr, aux
                )

            zero = jnp.zeros((2 * C + 1,), dtype=problem.inv_depth.dtype)
            J = jax.jacfwd(f)(zero)  # (R, 2C+1)
            r = f(zero)
            return r, J

        return jax.vmap(one)(cam_a, cam_c, rho, o.aux)

    def build_normal_eqs(problem: BAProblem, cfg: BAConfig):
        """Returns (cost, H_cc (K,K,C,C), H_cp (K,L,C), H_pp (L,), g_c (K,C),
        g_p (L,)).  All contributions weighted by Huber IRLS + validity."""
        o = problem.obs
        K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
        L = problem.inv_depth.shape[0]

        r, J = _obs_r_and_J(problem)  # (O, R), (O, R, 2C+1)
        vmask = o.valid[:, None] != 0
        r = jnp.where(vmask, r, 0.0)
        J = jnp.where(vmask[:, :, None], J, 0.0)
        r2 = jnp.sum(r * r, axis=-1)
        w = _robust_weights(r2, cfg.huber_delta) * o.valid  # (O,)
        cost = _robust_cost(r2, cfg.huber_delta)

        Ja = J[:, :, :C]          # (O, R, C)
        Jc = J[:, :, C : 2 * C]   # (O, R, C)
        Jp = J[:, :, 2 * C]       # (O, R)

        wJa = Ja * w[:, None, None]
        wJc = Jc * w[:, None, None]
        wJp = Jp * w[:, None]

        # camera-camera blocks: ONE merged scatter of all 4 contributions
        # per obs into (K^2, C^2) rows instead of four separate
        # (K, K, C, C) scatter-adds
        Haa = jnp.einsum("ori,orj->oij", wJa, Ja)
        Hac = jnp.einsum("ori,orj->oij", wJa, Jc)
        Hcc = jnp.einsum("ori,orj->oij", wJc, Jc)
        cc_idx = jnp.concatenate([
            o.anchor_cam * K + o.anchor_cam,
            o.anchor_cam * K + o.target_cam,
            o.target_cam * K + o.anchor_cam,
            o.target_cam * K + o.target_cam,
        ])
        cc_payload = jnp.concatenate([
            Haa, Hac, jnp.swapaxes(Hac, -1, -2), Hcc
        ]).reshape(4 * Haa.shape[0], C * C)
        H_cc = (
            jnp.zeros((K * K, C * C), r.dtype)
            .at[cc_idx].add(cc_payload)
            .reshape(K, K, C, C)
        )

        # camera-landmark couplings: scatter into (K, L, C) keeping the
        # landmark axis intact (it is the sharded axis in distributed runs)
        Hap = jnp.einsum("ori,or->oi", wJa, Jp)
        Hcp = jnp.einsum("ori,or->oi", wJc, Jp)
        H_cp = (
            jnp.zeros((K, L, C), r.dtype)
            .at[
                jnp.concatenate([o.anchor_cam, o.target_cam]),
                jnp.concatenate([o.landmark, o.landmark]),
            ]
            .add(jnp.concatenate([Hap, Hcp]))
        )

        # landmark (scalar) blocks
        H_pp = jnp.zeros((L,), r.dtype).at[o.landmark].add(
            jnp.einsum("or,or->o", wJp, Jp)
        )

        # gradient g = J^T r
        ga = jnp.einsum("ori,or->oi", wJa, r)
        gc = jnp.einsum("ori,or->oi", wJc, r)
        g_c = (
            jnp.zeros((K, C), r.dtype)
            .at[jnp.concatenate([o.anchor_cam, o.target_cam])]
            .add(jnp.concatenate([ga, gc]))
        )
        g_p = jnp.zeros((L,), r.dtype).at[o.landmark].add(
            jnp.einsum("or,or->o", wJp, r)
        )
        return cost, H_cc, H_cp, H_pp, g_c, g_p

    return residual_cost, build_normal_eqs


def schur_solve(
    H_cc, H_cp, H_pp, g_c, g_p, lam, free_cam_mask, lm_mask, cfg: BAConfig
):
    """Eliminate scalar landmark blocks, solve the reduced camera system by
    dense Cholesky, back-substitute.  Returns (delta_c (K,C), delta_p (L,))."""
    K, L, C = H_cp.shape
    dtype = H_cp.dtype

    H_cc_mat = jnp.transpose(H_cc, (0, 2, 1, 3)).reshape(K * C, K * C)
    H_cp_mat = jnp.transpose(H_cp, (0, 2, 1)).reshape(K * C, L)
    g_c_vec = g_c.reshape(K * C)

    # LM damping on the diagonals (Ceres-style scaled damping)
    d_cc = jnp.clip(jnp.diagonal(H_cc_mat), 1e-12, 1e32)
    H_cc_d = H_cc_mat + jnp.diag(lam * d_cc)
    H_pp_d = jnp.maximum(H_pp, cfg.min_inv_depth_hessian) * (1.0 + lam)

    # gauge fixing: zero rows/cols of fixed camera blocks, unit diagonal
    mask_c = jnp.repeat(free_cam_mask.astype(dtype), C)  # (KC,)
    inv_Hpp = lm_mask.astype(dtype) / H_pp_d

    Wcp = H_cp_mat * inv_Hpp[None, :]
    S = H_cc_d - Wcp @ H_cp_mat.T
    rhs = -(g_c_vec - Wcp @ g_p)

    S = S * mask_c[:, None] * mask_c[None, :] + jnp.diag(1.0 - mask_c)
    rhs = rhs * mask_c

    # dense Cholesky on the reduced camera system
    cho = jax.scipy.linalg.cho_factor(S, lower=True)
    delta_c = jax.scipy.linalg.cho_solve(cho, rhs)
    delta_c = delta_c * mask_c

    delta_p = -(g_p + H_cp_mat.T @ delta_c) * inv_Hpp
    return delta_c.reshape(K, C), delta_p


def make_ba_solver(
    residual_fn: Callable,
    cam_retract: Callable,
    cam_tangent_dim: int,
    normal_eq_fn: Callable | None = None,
    cost_fn: Callable | None = None,
    rj_fn: Callable | None = None,
):
    """Assemble a full jitted LM loop for a BA problem family.

    ``normal_eq_fn``/``cost_fn`` may be overridden (the distributed solver in
    ``parallel.dist_ba`` wraps them in ``shard_map`` with psums over the
    landmark shard axis).
    """
    res_cost, build_neq = make_ba_step(
        residual_fn, cam_retract, cam_tangent_dim, rj_fn=rj_fn
    )
    if normal_eq_fn is None:
        normal_eq_fn = build_neq
    if cost_fn is None:
        cost_fn = res_cost
    C = cam_tangent_dim

    def apply_step(problem: BAProblem, delta_c, delta_p):
        new_cams = jax.vmap(cam_retract)(problem.cam_states, delta_c)
        new_rho = problem.inv_depth + delta_p
        return problem._replace(cam_states=new_cams, inv_depth=new_rho)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def solve(problem: BAProblem, cfg: BAConfig = BAConfig()):
        free = ~problem.fixed_cams
        init_cost = cost_fn(problem, cfg)
        dtype = problem.inv_depth.dtype

        def body(state):
            prob, lam, cost, it, done = state
            _, H_cc, H_cp, H_pp, g_c, g_p = normal_eq_fn(prob, cfg)

            def inner_cond(s):
                lam_i, ok, _, tries, _, _ = s
                return (~ok) & (tries < cfg.max_retries) & (lam_i <= cfg.max_lambda)

            def inner_body(s):
                lam_i, _, _, tries, _, _ = s
                dc, dp = schur_solve(
                    H_cc, H_cp, H_pp, g_c, g_p, lam_i, free, prob.lm_valid, cfg
                )
                new_cost = cost_fn(apply_step(prob, dc, dp), cfg)
                ok = (new_cost < cost) & jnp.isfinite(new_cost)
                return (jnp.where(ok, lam_i, lam_i * 10.0), ok, new_cost,
                        tries + 1, dc, dp)

            dc0 = jnp.zeros((free.shape[0], C), dtype)
            dp0 = jnp.zeros_like(prob.inv_depth)
            # the accepting step's deltas ride the carry — no recompute
            lam_f, accepted, new_cost, _, dc_f, dp_f = jax.lax.while_loop(
                inner_cond, inner_body, (lam, False, cost, 0, dc0, dp0)
            )
            # select only the mutable state — a whole-pytree select would
            # copy the (large, constant) observation arrays every iteration
            p_acc = apply_step(prob, dc_f, dp_f)
            p_new = prob._replace(
                cam_states=jax.tree_util.tree_map(
                    lambda a, b: jnp.where(accepted, a, b),
                    p_acc.cam_states, prob.cam_states,
                ),
                inv_depth=jnp.where(accepted, p_acc.inv_depth, prob.inv_depth),
            )
            cost_new = jnp.where(accepted, new_cost, cost)
            lam_new = jnp.where(
                accepted, jnp.maximum(lam_f / 3.0, cfg.min_lambda), lam_f
            )
            small = jnp.abs(cost - cost_new) <= cfg.function_tolerance * jnp.maximum(
                cost, 1e-300
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
        return prob, BAResult(
            cost=cost, initial_cost=init_cost, iterations=iters, lam=lam
        )

    return solve
