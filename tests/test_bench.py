"""Smoke test for bench.py — the driver runs it after every round, so a
bit-rotted bench records nothing.  Exercises both the accelerator-style
(dense plan, autodiff Jacobians) and CPU-style (host plan, manual
Jacobians) step builders and the timing harness at toy scale."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402


@pytest.mark.parametrize("host_plan,manual", [(True, True), (False, False)])
def test_build_step_and_time_iters(host_plan, manual):
    import jax.numpy as jnp

    lm_step, problem = bench.build_step(
        jnp.float32, use_manual_jac=manual, host_plan=host_plan,
        K=6, L=64,
    )
    dt = bench.time_iters(lm_step, problem, iters=3)
    assert dt > 0.0


def test_build_pba_step_and_time_iters():
    import jax.numpy as jnp

    lm_step, problem, const = bench.build_pba_step(
        jnp.float32, K=12, L=48, obs_per_lm=3, H=64, W=96,
    )
    dt = bench.time_iters(lm_step, problem, iters=3, const=const)
    assert dt > 0.0


@pytest.mark.slow
def test_keyframes_composite_stage_timers():
    """The per-stage device timers behind the keyframes_per_s composite
    metric compile and run at toy shapes (the real shapes are EuRoC-sized;
    bench.py main exercises those on the accelerator)."""
    step, imgs = bench.build_detect_step(H=64, W=96, B=2, F=128)
    bench.time_devcalls(step, imgs, 3)
    chunk_fn, key, lane, I = bench.build_match_chunk(
        I=8, F=128, C=2, MM=128, hyps=8
    )
    bench.time_match_chunk(chunk_fn, key, lane, I, 3)
    geo = bench.build_geometry_steps(M_loc=128, M_rows=256)
    for _name, (fn, args) in geo.items():
        bench.time_devcalls(fn, args, 3)


def test_hot_programs_free_of_windowed_and_reversed_ops():
    """The hot compiled programs stay free of reversed/windowed lowerings
    (jnp.convolve, [..., ::-1] slices, lax.reduce_window) and
    convolutions: the detector's filters are shift-multiply-adds and the
    matcher is gathers, reductions and matmuls."""
    import re

    import jax

    import bench

    chunk_fn, key, lane, I = bench.build_match_chunk()
    i1 = (lane * 7) % I
    i2 = (lane * 11 + 1) % I
    txt = jax.jit(chunk_fn).lower(i1, i2, key).as_text()
    step, imgs = bench.build_detect_step()
    txt2 = jax.jit(step).lower(imgs).as_text()
    for name, t in [("match chunk", txt), ("detect batch", txt2)]:
        for pat in ("reduce_window", "stablehlo.reverse", "convolution"):
            n = len(re.findall(pat, t))
            assert n == 0, f"{name} contains {n} {pat} ops"


def test_workload_drift_guard():
    """bench.EUROC_WORKLOAD must be validated against the counters of a
    real run (apps.sfm --stats-out): matching counters -> no drift, a
    drifted workload -> flagged (round-2/3 verdict: frozen constants must
    fail loudly when the pipeline shape moves)."""
    import bench

    w = bench.EUROC_WORKLOAD
    stats = {
        "n_images": w["images"],
        "timings_s": {"ba_iters": w["ba_iters"]},
        "counters": {
            "detect_batches": w["detect_batches"],
            "match_chunks": w["match_chunks"],
            "stereo_chunks": w["stereo_chunks"],
            "localize_rows_1024": w["localize_calls_1024"],
            "triangulate_rows_1024": w["triangulate_rows"] // 1024,
            "project_rows_2048": w["project_rows"] // 2048,
            "lmpos_rows_512": w["lmpos_rows"] // 512,
        },
    }
    assert bench.workload_drift(stats) == {}

    stats["counters"]["match_chunks"] = 2 * w["match_chunks"]
    drift = bench.workload_drift(stats)
    assert list(drift) == ["match_chunks"]
    assert drift["match_chunks"] == (w["match_chunks"], 2 * w["match_chunks"])
