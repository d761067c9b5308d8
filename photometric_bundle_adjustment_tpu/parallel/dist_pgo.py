"""Distributed pose-graph optimisation over a device mesh.

BASELINE config #5 names "distributed photometric BA + pose-graph over
partitioned keyframe map blocks".  A pose graph has no landmarks, so the
natural decomposition is EDGE sharding — data parallelism over the
relative-pose factors (the analog of observation sharding in BA, and of
the reference's per-residual Ceres threading, map_utils.h:377-383):

  * the edge arrays (i, j, T_ij, weight) are sharded over the mesh's data
    axis; poses (K, 7) are replicated (keyframe counts are small next to
    edge counts);
  * each device evaluates its edges' residuals + (6 x 12) Jacobians in one
    vmapped computation and scatter-adds its 6x6 blocks into a local
    (K, K, 6, 6) normal-equation tensor;
  * the ONLY collective per build is one ``psum`` of (cost, H, g) —
    O(K^2) traffic independent of the edge count; per damping retry one
    scalar cost psum;
  * the damped solve runs replicated (for K large the camera-partitioned
    PCG of ``dist_fused`` applies unchanged — the reduced system has the
    same (6K x 6K) shape).

Residuals match ``models.pose_graph.pose_graph_optimization`` (the SE3
relative-pose factor generalising the reference's rotation/translation
averaging functors, include/visnav/global.h:44-86):

    r_e = weight_e * log( T_ij^-1 * T_wi^-1 * T_wj )   in R^6.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
from jax import shard_map
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from photometric_bundle_adjustment_tpu.core import se3
from photometric_bundle_adjustment_tpu.models.pose_graph import PoseGraph
from photometric_bundle_adjustment_tpu.optim.lm import LMConfig
from photometric_bundle_adjustment_tpu.parallel.mesh import DATA_AXIS


class ShardedPoseGraph(NamedTuple):
    graph: PoseGraph     # arrays (D * E_s, ...), edge-sharded on the mesh
    n_shards: int


def prepare(graph: PoseGraph, mesh: Mesh) -> ShardedPoseGraph:
    """Pad the edge axis to a multiple of the mesh size (padding edges get
    weight 0 and identity measurements) and place shards on the mesh."""
    D = mesh.devices.size
    E = graph.edge_i.shape[0]
    E_pad = ((E + D - 1) // D) * D

    def pad(x, fill):
        x = np.asarray(x)
        if x.shape[0] == E_pad:
            return x
        p = np.full((E_pad - x.shape[0],) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, p])

    ident = np.zeros(7, np.asarray(graph.T_ij).dtype)
    ident[6] = 1.0
    padded = PoseGraph(
        edge_i=jnp.asarray(pad(graph.edge_i, 0)),
        edge_j=jnp.asarray(pad(graph.edge_j, 0)),
        T_ij=jnp.asarray(np.concatenate([
            np.asarray(graph.T_ij),
            np.tile(ident, (E_pad - E, 1)),
        ]) if E_pad > E else np.asarray(graph.T_ij)),
        weight=jnp.asarray(pad(graph.weight, 0)),
    )
    data = NamedSharding(mesh, P(DATA_AXIS))
    padded = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, data), padded
    )
    return ShardedPoseGraph(padded, D)


def make_distributed_pgo(mesh: Mesh):
    """Returns solve(poses0 (K,7), sharded, fixed (K,) bool, cfg)
    -> (poses, (initial_cost, cost, iterations))."""
    def solve(poses0, sharded: ShardedPoseGraph, fixed,
              cfg: LMConfig = LMConfig()):
        K = poses0.shape[0]
        dtype = poses0.dtype

        @functools.partial(
            shard_map, mesh=mesh, check_vma=False,
            in_specs=(
                P(),
                jax.tree_util.tree_map(lambda _: P(DATA_AXIS),
                                       sharded.graph),
                P(),
            ),
            out_specs=(P(), P()),
        )
        def run(poses0, g, fixed):
            free = ~fixed
            freeD = jnp.repeat(free, 6)

            def edge_rj(poses):
                """Residuals (E_s, 6) and Jacobians (E_s, 6, 12) for the
                local edge shard, in one vmapped jacfwd evaluation."""
                T_i = poses[g.edge_i]
                T_j = poses[g.edge_j]

                def one(Ti, Tj, T_ij, w):
                    def f(d):
                        Ti_ = se3.right_plus(Ti, d[:6])
                        Tj_ = se3.right_plus(Tj, d[6:])
                        est = se3.compose(se3.inverse(Ti_), Tj_)
                        return w * se3.log(
                            se3.compose(se3.inverse(T_ij), est)
                        )

                    z = jnp.zeros(12, dtype)
                    return f(z), jax.jacfwd(f)(z)

                return jax.vmap(one)(T_i, T_j, g.T_ij, g.weight)

            def cost_fn(poses):
                r, _ = edge_rj(poses)
                return jax.lax.psum(0.5 * jnp.sum(r * r), DATA_AXIS)

            def build(poses):
                r, J = edge_rj(poses)
                Ji = J[:, :, :6]
                Jj = J[:, :, 6:]
                ei = g.edge_i
                ej = g.edge_j
                H = jnp.zeros((K, K, 6, 6), dtype)
                H = H.at[ei, ei].add(jnp.einsum("eri,erj->eij", Ji, Ji))
                H = H.at[ei, ej].add(jnp.einsum("eri,erj->eij", Ji, Jj))
                H = H.at[ej, ei].add(jnp.einsum("eri,erj->eij", Jj, Ji))
                H = H.at[ej, ej].add(jnp.einsum("eri,erj->eij", Jj, Jj))
                gv = jnp.zeros((K, 6), dtype)
                gv = gv.at[ei].add(jnp.einsum("eri,er->ei", Ji, r))
                gv = gv.at[ej].add(jnp.einsum("eri,er->ei", Jj, r))
                cost = 0.5 * jnp.sum(r * r)
                return jax.lax.psum((cost, H, gv), DATA_AXIS)

            def solve_lam(H, gv, lam):
                Hm = jnp.transpose(H, (0, 2, 1, 3)).reshape(6 * K, 6 * K)
                gm = gv.reshape(-1)
                # gauge: identity rows/cols on fixed tangent directions
                m = freeD.astype(dtype)
                Hm = Hm * (m[:, None] * m[None, :]) + jnp.diag(1.0 - m)
                d = jnp.clip(jnp.diagonal(Hm), 1e-12, 1e32)
                Hl = Hm + lam * jnp.diag(d)
                chol = jax.scipy.linalg.cho_factor(Hl, lower=True)
                delta = -jax.scipy.linalg.cho_solve(chol, gm * m) * m
                return delta.reshape(K, 6)

            def retract(poses, delta):
                return jax.vmap(se3.right_plus)(poses, delta)

            init_cost = cost_fn(poses0)

            def body(state):
                poses, lam, cost, it, done = state
                _, H, gv = build(poses)

                def inner_cond(s):
                    lam_i, ok, _, tries, _ = s
                    return (~ok) & (tries < 8) & (lam_i <= cfg.max_lambda)

                def inner_body(s):
                    lam_i, _, _, tries, _ = s
                    delta = solve_lam(H, gv, lam_i)
                    new_cost = cost_fn(retract(poses, delta))
                    ok = (new_cost < cost) & jnp.isfinite(new_cost)
                    return (jnp.where(ok, lam_i, lam_i * 10.0), ok,
                            new_cost, tries + 1, delta)

                lam_f, accepted, new_cost, _, delta_f = jax.lax.while_loop(
                    inner_cond, inner_body,
                    (lam, False, cost, 0, jnp.zeros((K, 6), dtype)),
                )
                p_acc = retract(poses, delta_f)
                poses_new = jnp.where(accepted, p_acc, poses)
                cost_new = jnp.where(accepted, new_cost, cost)
                lam_new = jnp.where(
                    accepted, jnp.maximum(lam_f / 3.0, cfg.min_lambda), lam_f
                )
                small = jnp.abs(cost - cost_new) <= (
                    cfg.function_tolerance * jnp.maximum(cost, 1e-300)
                )
                return (poses_new, lam_new, cost_new, it + 1,
                        (~accepted) | small)

            def cond(state):
                _, _, _, it, done = state
                return (~done) & (it < cfg.max_iterations)

            poses_f, _, cost, iters, _ = jax.lax.while_loop(
                cond, body,
                (poses0, jnp.asarray(cfg.init_lambda, dtype), init_cost,
                 jnp.asarray(0), jnp.asarray(False)),
            )
            return poses_f, jnp.stack(
                [init_cost, cost, iters.astype(dtype)]
            )

        with mesh:
            poses_f, stats = jax.jit(run)(
                poses0, sharded.graph, jnp.asarray(fixed)
            )
        return poses_f, (float(stats[0]), float(stats[1]), int(stats[2]))

    return solve
