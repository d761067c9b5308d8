"""Distributed bundle adjustment: landmark-sharded Schur-LM over a device
mesh.

Per-iteration data flow (SURVEY §7 step 7):
  1. each device evaluates residuals/Jacobians for its observation shard
     (observations are pre-sorted by landmark so a landmark's observations
     live on the same device as its inverse-depth entry),
  2. local accumulation of the camera-camera blocks and the per-shard
     columns of H_cp,
  3. the reduced camera system  S = H_cc - H_cp D^-1 H_pc  and its rhs are
     summed across devices (these are the ONLY cross-device reductions: a
     (6K x 6K) matrix + (6K,) vector per LM inner step — the landmark-sized
     structures never move),
  4. the dense Cholesky solve of S runs replicated; the landmark update
     back-substitutes locally per shard.

Implementation: the single-chip solver from ``optim.ba`` runs under ``jit``
with sharding constraints on the problem arrays (observation + landmark
axes sharded, camera state replicated); XLA's SPMD partitioner then emits
exactly the flow above — the big (KC, L) x (L, KC) matmul becomes a local
matmul + psum, scatter-adds to camera blocks become local + psum.  This is
the "annotate shardings, let XLA insert collectives" recipe; a hand-written
``shard_map`` path can replace it kernel-by-kernel if the compiled
collective schedule ever proves suboptimal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from photometric_bundle_adjustment_tpu.optim import ba
from photometric_bundle_adjustment_tpu.parallel.mesh import DATA_AXIS


def sort_obs_by_landmark(problem: ba.BAProblem) -> ba.BAProblem:
    """Reorder observations so each landmark's observations are contiguous;
    aligns the obs shards with the landmark shards."""
    order = jnp.argsort(problem.obs.landmark, stable=True)
    o = problem.obs
    obs = ba.BAObservations(
        anchor_cam=o.anchor_cam[order],
        target_cam=o.target_cam[order],
        landmark=o.landmark[order],
        aux=jax.tree_util.tree_map(lambda x: x[order], o.aux),
        valid=o.valid[order],
    )
    return problem._replace(obs=obs)


def shard_problem(problem: ba.BAProblem, mesh: Mesh) -> ba.BAProblem:
    """Place the problem on the mesh: observation/landmark axes sharded over
    the data axis, camera state + gauge masks replicated."""
    data = NamedSharding(mesh, P(DATA_AXIS))
    repl = NamedSharding(mesh, P())

    def put(x, sharding):
        return jax.device_put(x, sharding)

    o = problem.obs
    obs = ba.BAObservations(
        anchor_cam=put(o.anchor_cam, data),
        target_cam=put(o.target_cam, data),
        landmark=put(o.landmark, data),
        aux=jax.tree_util.tree_map(lambda x: put(x, data), o.aux),
        valid=put(o.valid, data),
    )
    return ba.BAProblem(
        cam_states=jax.tree_util.tree_map(lambda x: put(x, repl),
                                          problem.cam_states),
        inv_depth=put(problem.inv_depth, data),
        obs=obs,
        fixed_cams=put(problem.fixed_cams, repl),
        lm_valid=put(problem.lm_valid, data),
    )


def pad_problem_for_mesh(problem: ba.BAProblem, n_devices: int) -> ba.BAProblem:
    """Pad the L and O axes to multiples of the mesh size (static-shape
    sharding requirement); padded entries are masked invalid."""
    L = problem.inv_depth.shape[0]
    O = problem.obs.valid.shape[0]
    Lp = (-L) % n_devices
    Op = (-O) % n_devices
    if Lp == 0 and Op == 0:
        return problem
    o = problem.obs

    def pad0(x, n):
        return jnp.concatenate([x, jnp.zeros((n,) + x.shape[1:], x.dtype)])

    obs = ba.BAObservations(
        anchor_cam=pad0(o.anchor_cam, Op),
        target_cam=pad0(o.target_cam, Op),
        landmark=pad0(o.landmark, Op),
        aux=jax.tree_util.tree_map(lambda x: pad0(x, Op), o.aux),
        valid=pad0(o.valid, Op),
    )
    return problem._replace(
        obs=obs,
        inv_depth=pad0(problem.inv_depth, Lp),
        lm_valid=pad0(problem.lm_valid, Lp),
    )


def distributed_solver(residual_fn, cam_retract, cam_tangent_dim, mesh: Mesh,
                       rj_fn=None):
    """Build a mesh-aware BA solver.  Returns solve(problem, cfg) where the
    problem should be prepared with sort_obs_by_landmark + pad + shard."""
    solve = ba.make_ba_solver(
        residual_fn, cam_retract, cam_tangent_dim, rj_fn=rj_fn
    )

    def dist_solve(problem: ba.BAProblem, cfg: ba.BAConfig = ba.BAConfig()):
        with mesh:
            return solve(problem, cfg)

    return dist_solve


# Per-device budget for the dense (K, L, C) camera-landmark coupling this
# GSPMD path materialises (sharded over L).  Above it the partitioned
# formulation in parallel.dist_fused (camera_partition=True) is the right
# tool: O((KC)^2 / D) memory, matrix-free Schur products.  1 GiB leaves
# headroom next to images and normal equations on a 16 GiB device.
H_CP_BUDGET_BYTES = 1 << 30


def check_memory_budget(problem: ba.BAProblem, n_devices: int,
                        cam_tangent_dim: int = 6,
                        budget_bytes: int = H_CP_BUDGET_BYTES) -> None:
    """Refuse maps whose dense H_cp shard exceeds the per-device budget.

    Raises ValueError naming the partitioned alternative."""
    K = jax.tree_util.tree_leaves(problem.cam_states)[0].shape[0]
    L = problem.inv_depth.shape[0]
    itemsize = jnp.dtype(problem.inv_depth.dtype).itemsize
    per_device = K * L * cam_tangent_dim * itemsize / max(n_devices, 1)
    if per_device > budget_bytes:
        raise ValueError(
            f"dist_ba materialises a dense (K={K}, L={L}, C="
            f"{cam_tangent_dim}) camera-landmark coupling: "
            f"{per_device / 2**20:.0f} MiB per device exceeds the "
            f"{budget_bytes / 2**20:.0f} MiB budget. Use "
            "parallel.dist_fused.make_distributed_fused_solver("
            "camera_partition=True) for maps this size."
        )


def prepare(problem: ba.BAProblem, mesh: Mesh,
            cam_tangent_dim: int = 6) -> ba.BAProblem:
    n = mesh.devices.size
    check_memory_budget(problem, n, cam_tangent_dim)
    return shard_problem(
        pad_problem_for_mesh(sort_obs_by_landmark(problem), n), mesh
    )
