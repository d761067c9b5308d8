"""Distributed photometric BA on the 8-device fake mesh: sharded solve must
match single-device, and the (host, chip) 2-D mesh shape must build."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from photometric_bundle_adjustment_tpu.models import photometric_ba as pba
from photometric_bundle_adjustment_tpu.models import synthetic
from photometric_bundle_adjustment_tpu.optim import ba
from photometric_bundle_adjustment_tpu.parallel import dist_ba, mesh as mesh_mod


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 fake devices")
def test_distributed_photometric_matches_single():
    problem, images_flat, H, W, _, _ = synthetic.synth_pba_problem(
        K=4, L=64, dtype=jnp.float32
    )
    cfg = ba.BAConfig(max_iterations=6, huber_delta=9.0)

    solve_1 = pba.make_solver("pinhole", images_flat, H, W)
    solved_1, res_1 = solve_1(problem, cfg)

    mesh = mesh_mod.make_mesh(8)
    sharded = dist_ba.prepare(problem, mesh)
    solve_8 = dist_ba.distributed_solver(
        pba.make_residual_fn("pinhole", images_flat, H, W), pba.cam_retract,
        8, mesh,
        rj_fn=pba.make_rj_fn("pinhole", images_flat, H, W),
    )
    solved_8, res_8 = solve_8(sharded, cfg)

    np.testing.assert_allclose(float(res_1.cost), float(res_8.cost), rtol=1e-5)
    # single-device vs 8-shard psum reduce in different f32 summation
    # orders; over 6 LM iterations the pose params drift a few 1e-5 apart
    # (the costs above still agree to 1e-5 relative)
    np.testing.assert_allclose(
        np.asarray(solved_1.cam_states.pose),
        np.asarray(solved_8.cam_states.pose), atol=2e-4,
    )


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 fake devices")
def test_host_chip_mesh_shape():
    mesh = mesh_mod.make_host_chip_mesh(2, 4)
    assert mesh.devices.shape == (2, 4)
    assert mesh.axis_names == ("host", "data")


@pytest.mark.slow
def test_distributed_pba_on_real_map():
    """The distributed solvers had only ever seen
    synthetic problems.  Run a real (heavy-tailed) EuRoC mini-map through
    parallel/dist_fused.py on the 8-fake-device mesh and require agreement
    with the single-device fused solve."""
    import os

    from photometric_bundle_adjustment_tpu.io import calib_io, dataset
    from photometric_bundle_adjustment_tpu.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    data = "/root/reference/data/euroc_V1"
    if not os.path.isdir(data):
        pytest.skip("reference dataset not available")
    images, _ = dataset.load_images(data, max_frames=3)
    calib = calib_io.load_calibration(
        os.path.join(os.path.dirname(__file__), "data", "opt_calib_ds.json")
    )
    pipe = SfmPipeline(images, calib, SfmConfig(match_chunk_pairs=8),
                       seed=0, log=lambda *a: None)
    pipe.run()
    assert len(pipe.cameras) == 6

    res, parity = pba_refine.refine_photometric_distributed(
        pipe, n_devices=8, max_iterations=4, log=lambda *a: None,
    )
    assert np.isfinite(float(res.cost))
    assert float(res.cost) < float(res.initial_cost)
    assert parity is not None
    # same assembly math on landmark-aligned shards: tight agreement
    assert parity["cost_rel"] < 1e-4
    assert parity["pose_maxdiff"] < 1e-3


def test_pba_app_distributed_needs_enough_devices(monkeypatch, capsys):
    """``apps.pba --distributed D`` uses the backend's real devices and
    refuses D beyond them, instead of switching platform."""
    from photometric_bundle_adjustment_tpu.apps import pba as pba_app
    from photometric_bundle_adjustment_tpu.models import synthetic
    from photometric_bundle_adjustment_tpu.utils import runtime

    monkeypatch.setattr(runtime, "configure_runtime", lambda: None)
    backend = jax.default_backend()
    n = len(jax.devices())
    with pytest.raises(SystemExit) as e:
        pba_app.main([
            "--dataset-path", "synthetic:0",
            "--cam-calib", synthetic.EUROC_CALIB,
            "--distributed", str(n + 1),
        ])
    assert e.value.code == 2
    assert f"needs {n + 1} devices" in capsys.readouterr().err
    assert jax.default_backend() == backend and len(jax.devices()) == n
