"""Damped Levenberg-Marquardt on product manifolds, fully jit-compiled.

Batched replacement for the reference's use of Ceres autodiff NLLS with
``LocalParameterization`` (DENSE_QR / SPARSE_NORMAL_CHOLESKY configs:
src/test_ceres_se3.cpp:69-76, src/calibration.cpp:410-418).  The Schur-
complement BA solver for large problems lives in
``photometric_bundle_adjustment_tpu.optim.schur``.

Design: the caller supplies
  * ``params``       — arbitrary pytree of arrays,
  * ``retract(params, delta)`` — maps a flat tangent vector ``(D,)`` back onto
    the manifold (e.g. right-plus ``T * exp(dx)`` per pose block).  This IS
    the Ceres local-parameterization: the Jacobian is taken through
    ``residual_fn(retract(params, delta))`` at ``delta = 0`` with ``jacfwd``,
    so autodiff produces exactly the minimal-coordinate Jacobian.
  * ``residual_fn(params)`` — flat residual vector ``(R,)``.

Robustification follows Ceres' loss-function correction in its IRLS form:
residual blocks of size ``block_size`` are reweighted by ``sqrt(rho'(s))``
with Huber rho (map_utils.h:370), and the reported cost is
``0.5 * sum rho(s)``.

The whole optimisation (including the trust-region lambda loop) runs inside a
single ``lax.while_loop`` so it compiles to one XLA computation: no host
round-trips per iteration.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class LMConfig(NamedTuple):
    max_iterations: int = 20
    # matches the reference's calibration/SE3-test tolerances of 0.01*eps when
    # set accordingly; defaults are pragmatic
    function_tolerance: float = 1e-12
    gradient_tolerance: float = 1e-14
    parameter_tolerance: float = 1e-14
    init_lambda: float = 1e-4
    min_lambda: float = 1e-14
    max_lambda: float = 1e10
    # Huber loss parameter; <= 0 disables robustification
    huber_delta: float = -1.0
    # residual block size used for robust weighting (2 = pixel residuals)
    block_size: int = 2


class LMResult(NamedTuple):
    cost: jax.Array            # final cost 0.5 * sum rho(s)
    initial_cost: jax.Array
    iterations: jax.Array
    lam: jax.Array
    grad_max: jax.Array


def huber_weights(r: jax.Array, delta: float, block_size: int) -> jax.Array:
    """Per-residual IRLS weights sqrt(rho'(s)) for Huber rho on squared block
    norms s = ||r_block||^2; rho(s) = s for s <= delta^2 else 2 delta sqrt(s)
    - delta^2 (Ceres HuberLoss convention)."""
    rb = r.reshape(-1, block_size)
    s = jnp.sum(rb * rb, axis=-1)
    sqrt_s = jnp.sqrt(jnp.maximum(s, 1e-300))
    w = jnp.where(s <= delta * delta, 1.0, delta / sqrt_s)  # rho'(s)
    w = jnp.sqrt(w)
    return jnp.repeat(w, block_size)


def huber_cost(r: jax.Array, delta: float, block_size: int) -> jax.Array:
    rb = r.reshape(-1, block_size)
    s = jnp.sum(rb * rb, axis=-1)
    sqrt_s = jnp.sqrt(jnp.maximum(s, 1e-300))
    rho = jnp.where(s <= delta * delta, s, 2.0 * delta * sqrt_s - delta * delta)
    return 0.5 * jnp.sum(rho)


def _cost_of(r: jax.Array, cfg: LMConfig) -> jax.Array:
    if cfg.huber_delta > 0:
        return huber_cost(r, cfg.huber_delta, cfg.block_size)
    return 0.5 * jnp.sum(r * r)


@functools.partial(
    jax.jit, static_argnames=("residual_fn", "retract", "tangent_dim", "cfg")
)
def lm_solve(
    residual_fn: Callable,
    params,
    retract: Callable,
    tangent_dim: int,
    cfg: LMConfig = LMConfig(),
    fixed_mask: jax.Array | None = None,
):
    """Minimise ``0.5 * sum rho(residual_fn(params)^2)`` over the manifold.

    Args:
      residual_fn: pytree params -> flat residuals (R,).
      retract: (params, delta (D,)) -> params.
      tangent_dim: D (static).
      fixed_mask: optional bool (D,) — tangent directions held constant
        (gauge fixing; the reference fixes whole camera blocks,
        src/sfm.cpp:1903, calibration.cpp:386-388).

    Returns: (params, LMResult).
    """
    D = tangent_dim
    r0 = residual_fn(params)
    dtype = r0.dtype
    zeros = jnp.zeros((D,), dtype)
    free = (
        jnp.ones((D,), dtype)
        if fixed_mask is None
        else jnp.asarray(~fixed_mask, dtype)
    )

    def weighted_r_J(p):
        r = residual_fn(p)
        J = jax.jacfwd(lambda d: residual_fn(retract(p, d)))(zeros)
        if cfg.huber_delta > 0:
            w = huber_weights(r, cfg.huber_delta, cfg.block_size)
            r = r * w
            J = J * w[:, None]
        J = J * free[None, :]
        return r, J

    init_cost = _cost_of(r0, cfg)

    def body(state):
        p, lam, cost, it, done, gmax = state
        r, J = weighted_r_J(p)
        g = J.T @ r
        H = J.T @ J
        diag = jnp.clip(jnp.diagonal(H), 1e-12, 1e32)
        gmax_new = jnp.max(jnp.abs(g) * free)

        def try_step(lam_try):
            A = H + jnp.diag(lam_try * diag) + jnp.diag(1e-32 + (1.0 - free))
            delta = -jnp.linalg.solve(A, g)
            delta = delta * free
            p_try = retract(p, delta)
            new_cost = _cost_of(residual_fn(p_try), cfg)
            # predicted reduction for the damped GN model
            pred = -(delta @ g) - 0.5 * delta @ (H @ delta)
            return p_try, new_cost, pred, delta

        # inner loop: increase lambda until the step is accepted (bounded)
        def inner_cond(s):
            lam_i, accepted, _, _, tries = s
            return (~accepted) & (tries < 8) & (lam_i <= cfg.max_lambda)

        def inner_body(s):
            lam_i, _, _, _, tries = s
            p_try, new_cost, pred, delta = try_step(lam_i)
            ok = (new_cost < cost) & jnp.isfinite(new_cost)
            lam_next = jnp.where(ok, lam_i, lam_i * 4.0)
            return (lam_next, ok, new_cost, delta, tries + 1)

        lam_f, accepted, new_cost, delta, _ = jax.lax.while_loop(
            inner_cond,
            inner_body,
            (lam, False, cost, jnp.zeros((D,), dtype), 0),
        )
        # on acceptance re-take the step at the accepted lambda
        p_acc, acc_cost, _, delta_acc = try_step(lam_f)
        p_new = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accepted, a, b), p_acc, p
        )
        cost_new = jnp.where(accepted, acc_cost, cost)
        lam_new = jnp.where(accepted, jnp.maximum(lam_f / 4.0, cfg.min_lambda), lam_f)

        small_decrease = jnp.abs(cost - cost_new) <= cfg.function_tolerance * jnp.maximum(
            cost, 1e-300
        )
        small_grad = gmax_new <= cfg.gradient_tolerance
        small_step = jnp.linalg.norm(delta_acc) <= cfg.parameter_tolerance
        done_new = (
            (~accepted)
            | small_grad
            | (accepted & (small_decrease | small_step))
            | (it + 1 >= cfg.max_iterations)
        )
        return (p_new, lam_new, cost_new, it + 1, done_new, gmax_new)

    def cond(state):
        _, _, _, it, done, _ = state
        return (~done) & (it < cfg.max_iterations)

    state0 = (
        params,
        jnp.asarray(cfg.init_lambda, dtype),
        init_cost,
        jnp.asarray(0),
        jnp.asarray(False),
        jnp.asarray(jnp.inf, dtype),
    )
    p_fin, lam, cost, iters, _, gmax = jax.lax.while_loop(cond, body, state0)
    return p_fin, LMResult(
        cost=cost, initial_cost=init_cost, iterations=iters, lam=lam, grad_max=gmax
    )
