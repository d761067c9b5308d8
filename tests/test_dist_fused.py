"""Distributed fused-assembly BA vs single-device solves on a fake mesh."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.models import geometric_ba, synthetic
from photometric_bundle_adjustment_tpu.optim import ba, fused
from photometric_bundle_adjustment_tpu.parallel import dist_fused
from photometric_bundle_adjustment_tpu.parallel import mesh as mesh_mod


@pytest.mark.slow
def test_distributed_fused_matches_single_device():
    problem, _, _ = synthetic.synth_ba_problem(
        model="pinhole", K=12, L=96, obs_per_landmark=4,
        pixel_noise=0.5, dtype=jnp.float32,
    )
    cfg = ba.BAConfig(max_iterations=8, huber_delta=1.0)
    res_fn = geometric_ba.make_residual_fn("pinhole")

    # single-device fused solve
    plan = fused.plan_for_problem(problem)
    fsolve = fused.make_fused_ba_solver(res_fn, geometric_ba.cam_retract, 6)
    p_single, r_single = fsolve(problem, plan, cfg)

    # 8-way landmark-sharded fused solve
    mesh = mesh_mod.make_mesh(8)
    sharded = dist_fused.prepare(problem, mesh)
    dsolve = dist_fused.make_distributed_fused_solver(
        res_fn, geometric_ba.cam_retract, 6, mesh
    )
    p_dist, r_dist = dsolve(sharded, cfg)

    assert np.isfinite(float(r_dist.cost))
    assert float(r_dist.initial_cost) == float(
        jax.device_get(r_single.initial_cost)
    ) or abs(
        float(r_dist.initial_cost) - float(r_single.initial_cost)
    ) < 1e-6 * float(r_single.initial_cost) + 1e-9
    # the LM trajectories agree (same assembly math, landmark-aligned shards)
    assert abs(float(r_dist.cost) - float(r_single.cost)) <= (
        1e-4 * float(r_single.cost) + 1e-9
    )
    # camera states agree
    dc = np.abs(
        np.asarray(p_dist.cam_states) - np.asarray(p_single.cam_states)
    ).max()
    assert dc < 1e-4

    # verify real sharding: inv_depth is split over all 8 devices
    n_shards = len(sharded.problem.inv_depth.sharding.device_set)
    assert n_shards == 8


def test_distributed_fused_photometric():
    from photometric_bundle_adjustment_tpu.models import photometric_ba as pba

    problem, images_flat, H, W, _, _ = synthetic.synth_pba_problem(
        K=4, L=64, dtype=jnp.float32
    )
    cfg = ba.BAConfig(max_iterations=3, huber_delta=9.0)
    res_fn = pba.make_residual_fn("pinhole", images_flat, H, W)
    mesh = mesh_mod.make_mesh(8)
    sharded = dist_fused.prepare(problem, mesh)
    dsolve = dist_fused.make_distributed_fused_solver(
        res_fn, pba.cam_retract, 8, mesh, rj_fn=pba.make_rj_fn(
            "pinhole", images_flat, H, W
        )
    )
    p_dist, r = dsolve(sharded, cfg)
    assert np.isfinite(float(r.cost))
    assert float(r.cost) <= float(r.initial_cost)


@pytest.mark.slow
def test_distributed_dense_layout_matches_single_device():
    """prepare(layout='dense'): landmark-dense shard-local layout solves to
    the same result as the single-device fused solve (ragged obs counts)."""
    problem, _, _ = synthetic.synth_ba_problem(
        model="pinhole", K=12, L=96, obs_per_landmark=4,
        pixel_noise=0.5, dtype=jnp.float32,
    )
    rng = np.random.default_rng(3)
    v = np.asarray(problem.obs.valid).copy()
    v[rng.random(v.shape[0]) < 0.25] = 0
    problem = problem._replace(obs=problem.obs._replace(valid=jnp.asarray(v)))
    cfg = ba.BAConfig(max_iterations=8, huber_delta=1.0)
    res_fn = geometric_ba.make_residual_fn("pinhole")

    plan = fused.plan_for_problem(problem)
    fsolve = fused.make_fused_ba_solver(res_fn, geometric_ba.cam_retract, 6)
    p_single, r_single = fsolve(problem, plan, cfg)

    mesh = mesh_mod.make_mesh(8)
    sharded = dist_fused.prepare(problem, mesh, layout="dense")
    assert isinstance(sharded.plans, dist_fused.DenseLmSchurPlan)
    dsolve = dist_fused.make_distributed_fused_solver(
        res_fn, geometric_ba.cam_retract, 6, mesh
    )
    p_dist, r_dist = dsolve(sharded, cfg)

    assert np.isfinite(float(r_dist.cost))
    assert abs(float(r_dist.cost) - float(r_single.cost)) <= (
        1e-4 * float(r_single.cost) + 1e-9
    )
    dc = np.abs(
        np.asarray(p_dist.cam_states) - np.asarray(p_single.cam_states)
    ).max()
    assert dc < 1e-4


@pytest.mark.slow
def test_camera_partitioned_pcg_matches_replicated():
    """The reduced camera system solved
    camera-row-partitioned (matrix-free Schur PCG, psum_scatter/all_gather
    collectives) must reproduce the replicated dense-Cholesky solve."""
    problem, _, _ = synthetic.synth_ba_problem(
        model="pinhole", K=24, L=192, obs_per_landmark=4,
        pixel_noise=0.5, dtype=jnp.float32,
    )
    cfg = ba.BAConfig(max_iterations=6, huber_delta=1.0)
    res_fn = geometric_ba.make_residual_fn("pinhole")
    mesh = mesh_mod.make_mesh(8)
    sharded = dist_fused.prepare(problem, mesh)

    dsolve_rep = dist_fused.make_distributed_fused_solver(
        res_fn, geometric_ba.cam_retract, 6, mesh
    )
    p_rep, r_rep = dsolve_rep(sharded, cfg)

    dsolve_pcg = dist_fused.make_distributed_fused_solver(
        res_fn, geometric_ba.cam_retract, 6, mesh,
        camera_partition=True, n_cg=600, cg_tol=1e-12,
    )
    p_pcg, r_pcg = dsolve_pcg(sharded, cfg)

    assert np.isfinite(float(r_pcg.cost))
    assert abs(float(r_pcg.cost) - float(r_rep.cost)) <= (
        1e-4 * float(r_rep.cost) + 1e-9
    )
    dc = np.abs(
        np.asarray(p_pcg.cam_states) - np.asarray(p_rep.cam_states)
    ).max()
    assert dc < 1e-3, dc
