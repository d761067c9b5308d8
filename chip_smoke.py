"""Chip smoke test: the main path of the system on one GPU, end to end.

    python chip_smoke.py                 # one card: phases a-e
    python chip_smoke.py --multi-card    # four cards: distributed solve only

Phases, in one process, each printing its seconds and checks on one line;
none is caught, so any failure exits non-zero:

  a. device      the JAX backend must be a GPU; prints the card, the JAX
                 version, nvidia-smi's name and power limit and the
                 matmul precision in force.
  b. pipeline    ``apps.pba`` on the seeded EuRoC-shaped sequence
                 (``synthetic:<seed>``, 82 stereo pairs at 752x480):
                 detection, stereo and all-pairs matching with 5-point
                 RANSAC, incremental SfM with its BA solves, then the
                 3-level photometric refinement.  Checks the share of
                 cameras mapped, a falling photometric cost at every
                 level and the cam-0 ATE against the rendered truth.
  c. real BA     the repository's real EuRoC V1 map (164 cameras) and
                 corner cache, poses perturbed from the seed, one global
                 BA through the pipeline's own problem build and solve.
                 Checks the cost falls and the SE3 ATE against the
                 reference trajectory.
  d. parity      at real widths on the card: the fused geometric build +
                 damped solve against the plain autodiff build, the
                 gather-sampled photometric fused build against the plain
                 build, and the int8-matmul Hamming form against
                 xor+popcount on the real descriptors.
  e. trace       a ``jax.profiler`` trace of three photometric LM
                 iterations: top device operations and the share of the
                 gather (patch sampling) fusions.

Each phase line ends with its backend compiles (and how many came from the
persistent compilation cache); the run's totals follow the phases.  The
last line of standard output is one JSON object naming the device.
With ``--multi-card`` only ``apps.pba --distributed 4`` runs, with the
single-card comparison it computes, and the device count is 4.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "photometric_bundle_adjustment_tpu"
CALIB = os.path.join(HERE, "refbaseline", "artifacts", "ref_opt_calib.json")
REF_TRAJECTORY = os.path.join(HERE, "refbaseline", "artifacts",
                              "run_v1_trajectory.txt")
REAL_MAP = os.path.join(HERE, "runs", "map_r5_run16.pkl")
REAL_CORNERS = os.path.join(HERE, "runs", "cache_r5")

MIN_CAMERA_SHARE = 0.95
# cam-0 SE3 ATE of the photometric map against the rendered truth
ATE_BOUND_SYNTHETIC_M = 0.01
# SE3 ATE of the real map after BA against the reference trajectory
ATE_BOUND_REAL_M = 0.03
STEP_REL_TOL = 1e-4          # f32 step parity, matmuls at full precision
MULTI_CARD_COST_REL_TOL = 1e-3
MULTI_CARD_FRAMES = 12


class Phase:
    """Times one phase and prints ``[name] <s>s check; check; ...``;
    raises at the end if any check failed."""

    def __init__(self, name):
        self.name = name
        self.items = []
        self.failed = []

    def note(self, text):
        self.items.append(text)

    def check(self, ok, text):
        self.items.append(("ok " if ok else "FAILED ") + text)
        if not ok:
            self.failed.append(text)


COMPILES = {"compiles": 0, "compile_s": 0.0, "hits": 0, "written": 0}


@contextlib.contextmanager
def phase(name):
    p = Phase(name)
    t0 = time.time()
    c0 = dict(COMPILES)
    yield p
    p.note(f"{COMPILES['compiles'] - c0['compiles']} compiles "
           f"{COMPILES['compile_s'] - c0['compile_s']:.1f}s "
           f"({COMPILES['hits'] - c0['hits']} from the persistent cache)")
    print(f"[{name}] {time.time() - t0:.1f}s " + "; ".join(p.items),
          flush=True)
    if p.failed:
        raise SystemExit(f"phase {name} failed: {'; '.join(p.failed)}")


def rel_err(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def ate_se3(cams: dict, truth: dict, cam_id=None) -> float:
    import numpy as np

    from photometric_bundle_adjustment_tpu.utils import evaluation

    shared = sorted(f for f in set(cams) & set(truth)
                    if cam_id is None or f[1] == cam_id)
    a = np.stack([np.asarray(cams[f])[:3] for f in shared])
    b = np.stack([np.asarray(truth[f])[:3] for f in shared])
    return evaluation.ate_rmse(a, b, with_scale=False)


# --------------------------------------------------------------------- a


def phase_device(n_cards: int):
    import jax

    with phase("a device") as p:
        backend = jax.default_backend()
        if backend != "gpu":
            raise SystemExit(f"no GPU: JAX backend is {backend!r}")
        devs = jax.devices()
        if len(devs) < n_cards:
            raise SystemExit(f"needs {n_cards} GPUs, found {len(devs)}")
        smi = nvidia_smi()
        print(smi, flush=True)
        p.note(f"device_kind={devs[0].device_kind}")
        p.note(f"count={len(devs)}")
        p.note(f"jax={jax.__version__}")
        p.note(f"nvidia-smi={smi!r}")
        prec = jax.config.jax_default_matmul_precision
        p.check(prec == "float32", f"matmul precision={prec}")
    return devs


# --------------------------------------------------------------------- b


def phase_pipeline(seed: int, work: str, n_frames: int = 82):
    from photometric_bundle_adjustment_tpu.apps import pba as pba_app
    from photometric_bundle_adjustment_tpu.io import dataset
    from photometric_bundle_adjustment_tpu.models import synthetic

    with phase("b pipeline") as p:
        t0 = time.time()
        dataset.load_images(f"synthetic:{seed}", n_frames)
        p.note(f"render {time.time() - t0:.1f}s")
        map_out = os.path.join(work, "map_pba.pkl")
        t0 = time.time()
        rc = pba_app.main([
            "--dataset-path", f"synthetic:{seed}",
            "--max-frames", str(n_frames),
            "--cam-calib", CALIB,
            "--cache-dir", work,
            "--map-out", map_out,
        ])
        p.note(f"apps.pba {time.time() - t0:.1f}s")
        p.check(rc == 0, f"apps.pba exit {rc}")
        with open(map_out, "rb") as f:
            m = pickle.load(f)
        n_cams = len(m["cameras"])
        p.check(n_cams >= MIN_CAMERA_SHARE * 2 * n_frames,
                f"cameras {n_cams}/{2 * n_frames}")
        levels = m["photometric_levels"]
        p.check(len(levels) == 3, f"{len(levels)} pyramid levels")
        for level, c0, c1, it in levels:
            p.check(c1 < c0, f"level {level} cost {c0:.4e}->{c1:.4e} ({it} it)")
        _, _, truth = synthetic.render_stereo_sequence(seed, n_frames)
        ate0 = ate_se3(m["cameras"], truth, cam_id=0)
        p.check(ate0 < ATE_BOUND_SYNTHETIC_M,
                f"cam-0 ATE {100 * ate0:.3f} cm (bound "
                f"{100 * ATE_BOUND_SYNTHETIC_M:.1f} cm)")
        p.note(f"cam-1 ATE {100 * ate_se3(m['cameras'], truth, 1):.3f} cm")
    return m


# --------------------------------------------------------------------- c


def _real_pipeline():
    """SfmPipeline holding the repository's real EuRoC V1 map and corner
    cache (the images themselves are not in the repository; nothing in
    the BA path reads pixels)."""
    import numpy as np

    from photometric_bundle_adjustment_tpu.io import calib_io
    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    with open(REAL_MAP, "rb") as f:
        m = pickle.load(f)
    n_frames = max(f for f, _ in m["cameras"]) + 1
    blank = np.zeros((480, 752), np.uint8)
    images = {(f, c): blank for f in range(n_frames) for c in range(2)}
    pipe = SfmPipeline(images, calib_io.load_calibration(CALIB), SfmConfig(),
                       cache_dir=REAL_CORNERS, log=lambda *a: None)
    if not pipe._load_cache("corners"):
        raise SystemExit(f"no corner cache under {REAL_CORNERS}")
    pipe.load_map(m)
    return pipe


def phase_real_ba(seed: int):
    import numpy as np

    from photometric_bundle_adjustment_tpu.core import se3
    from photometric_bundle_adjustment_tpu.models import synthetic
    from photometric_bundle_adjustment_tpu.optim import ba

    with phase("c real BA") as p:
        pipe = _real_pipeline()
        ref = synthetic.load_trajectory(REF_TRAJECTORY)
        p.note(f"{len(pipe.cameras)} cameras, {len(pipe.landmarks)} landmarks")
        p.note(f"map ATE {100 * ate_se3(pipe.cameras, ref):.2f} cm")
        # seeded perturbation of every free camera: 1 cm, ~0.2 degrees
        rng = np.random.default_rng(seed)
        for f in sorted(pipe.cameras):
            if f[0] == 0:
                continue   # the gauge cameras stay fixed
            d = np.concatenate([rng.normal(0, 0.01, 3),
                                rng.normal(0, 0.0035, 3)])
            pipe.cameras[f] = np.asarray(
                se3.right_plus(np.asarray(pipe.cameras[f]), d), np.float64)
        p.note(f"perturbed ATE {100 * ate_se3(pipe.cameras, ref):.2f} cm")
        problem, cam_list, lm_list = pipe._build_ba_problem()
        cfg = ba.BAConfig(max_iterations=20,
                          huber_delta=pipe.cfg.reprojection_error_huber_pixel)
        res = pipe._run_ba_solve(problem, cam_list, lm_list, cfg)
        p.check(float(res.cost) < float(res.initial_cost),
                f"cost {float(res.initial_cost):.6e}->{float(res.cost):.6e} "
                f"({int(res.iterations)} it)")
        ate = ate_se3(pipe.cameras, ref)
        p.check(ate <= ATE_BOUND_REAL_M,
                f"ATE {100 * ate:.2f} cm (bound {100 * ATE_BOUND_REAL_M:.0f} cm)")
    return pipe, problem


# --------------------------------------------------------------------- d


def _to_f32(tree):
    import jax
    import jax.numpy as jnp
    import numpy as np

    def cast(x):
        x = np.asarray(x)
        return jnp.asarray(x, jnp.float32 if x.dtype.kind == "f" else None)

    return jax.tree_util.tree_map(cast, tree)


def _step_parity(build, solver, plan, problem, fused_problem, cfg, lam):
    """One build + damped solve (LM lambda ``lam``) through the plain
    per-block normal equations (``ba.make_ba_step`` + ``ba.schur_solve``)
    and through the fused solver.  Returns (cost rel err, step rel err in
    the Euclidean norm, step rel err in the norm of the plain build's
    Gauss-Newton matrix H).

    The H-norm ||d||_H = sqrt(d^T H d) = ||J d|| measures what a step
    changes in the residuals; f32 rounding along the near-null directions
    of a real map's reduced system moves the Euclidean error of either
    formulation by up to ~1e-4 relative to an f64 solve, while its H-norm
    error stays near 1e-5."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from photometric_bundle_adjustment_tpu.optim import ba

    lam = jnp.asarray(lam, problem.inv_depth.dtype)
    free = ~problem.fixed_cams
    c0, *neq0 = jax.jit(build, static_argnums=1)(problem, cfg)
    dc0, dp0 = jax.jit(ba.schur_solve, static_argnums=8)(
        *neq0, lam, free, problem.lm_valid, cfg)
    c1, neq1 = solver.build(fused_problem, plan, cfg)
    dc1, dp1 = solver.solve_lam(neq1, plan, lam, free, cfg)

    H_cc, H_cp, H_pp = (np.asarray(x, np.float64) for x in neq0[:3])
    cam_mask = np.asarray(free, np.float64)[:, None]
    lm_mask = np.asarray(problem.lm_valid, np.float64)

    def h_norm2(dc, dp):
        dc = np.asarray(dc, np.float64) * cam_mask
        dp = np.asarray(dp, np.float64) * lm_mask
        return (np.einsum("ic,ijcd,jd->", dc, H_cc, dc)
                + 2.0 * np.einsum("ic,ilc,l->", dc, H_cp, dp)
                + np.sum(H_pp * dp * dp))

    e = np.asarray(dc1, np.float64) - np.asarray(dc0, np.float64)
    f = np.asarray(dp1, np.float64) - np.asarray(dp0, np.float64)
    h_rel = float(np.sqrt(max(h_norm2(e, f), 0.0) / h_norm2(dc0, dp0)))
    euclid = rel_err(np.concatenate([np.ravel(dc1), np.ravel(dp1)]),
                     np.concatenate([np.ravel(dc0), np.ravel(dp0)]))
    return rel_err(c1, c0), euclid, h_rel


def geometric_step_parity(problem, model: str, lam: float = 1e-4):
    """Fused geometric build (the plan ``_accel_plan`` picks) against the
    plain autodiff build, in f32 at real width."""
    from photometric_bundle_adjustment_tpu.models import geometric_ba
    from photometric_bundle_adjustment_tpu.optim import ba

    cfg = ba.BAConfig(huber_delta=1.0)
    problem = _to_f32(problem)
    _, build = ba.make_ba_step(geometric_ba.make_residual_fn(model),
                               geometric_ba.cam_retract, 6)
    dense, plan = geometric_ba._accel_plan(problem)
    return _step_parity(build, geometric_ba.make_fused_solver(model), plan,
                        problem, dense, cfg, lam)


def photometric_step_parity(problem, model, images_flat, H, W, seed: int,
                            lam: float = 1e-4):
    """Gather-sampled ``make_fused_solver`` against the plain
    ``make_solver`` formulation on one pyramid level.  The refined map is
    at its optimum, where the f32 gradient is mostly rounding, so the free
    poses are first moved off it by the seeded perturbation of phase c
    (1 cm, 3.5 mrad)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from photometric_bundle_adjustment_tpu.core import se3
    from photometric_bundle_adjustment_tpu.models import photometric_ba as pba
    from photometric_bundle_adjustment_tpu.optim import ba, fused

    pose = problem.cam_states.pose
    rng = np.random.default_rng(seed)
    d = np.concatenate([rng.normal(0, 0.01, (pose.shape[0], 3)),
                        rng.normal(0, 0.0035, (pose.shape[0], 3))], axis=1)
    d *= ~np.asarray(problem.fixed_cams)[:, None]
    problem = problem._replace(cam_states=problem.cam_states._replace(
        pose=jax.vmap(se3.right_plus)(pose, jnp.asarray(d, pose.dtype))))
    cfg = ba.BAConfig(huber_delta=9.0)
    _, build = ba.make_ba_step(
        pba.make_residual_fn(model, images_flat, H, W), pba.cam_retract, 8,
        rj_fn=pba.make_rj_fn(model, images_flat, H, W),
    )
    solver = pba.make_fused_solver(model, images_flat, H, W)
    return _step_parity(build, solver, fused.plan_for_problem(problem),
                        problem, problem, cfg, lam)


def hamming_parity(corners: dict, n_pairs: int = 64) -> tuple[int, int]:
    """(mismatching entries, entries compared) between the int8-matmul
    and xor+popcount Hamming matrices over real descriptor pairs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from photometric_bundle_adjustment_tpu.features import match

    fcids = sorted(corners)
    desc = jnp.asarray(np.stack([corners[f]["desc"] for f in fcids]))
    rng = np.random.default_rng(0)
    i1 = jnp.asarray(rng.integers(0, len(fcids), n_pairs))
    i2 = jnp.asarray(rng.integers(0, len(fcids), n_pairs))

    @jax.jit
    def mismatches(i1, i2):
        a, b = desc[i1], desc[i2]
        mm = jax.vmap(match.hamming_matrix_mxu)(a, b)
        pc = jax.vmap(match.hamming_matrix_popcount)(a, b)
        return jnp.sum(mm != pc), mm.size

    bad, size = mismatches(i1, i2)
    return int(bad), int(size)


def photometric_level_problem(seed: int, work: str, map_b: dict, level=0):
    """Phase b's photometric problem at pyramid ``level``, rebuilt from
    its saved map and corner cache."""
    from photometric_bundle_adjustment_tpu.io import calib_io, dataset
    from photometric_bundle_adjustment_tpu.models import photometric_ba as pba
    from photometric_bundle_adjustment_tpu.pipeline import pba_refine
    from photometric_bundle_adjustment_tpu.pipeline.config import SfmConfig
    from photometric_bundle_adjustment_tpu.pipeline.sfm_pipeline import (
        SfmPipeline,
    )

    n_frames = max(f for f, _ in map_b["cameras"]) + 1
    images, _ = dataset.load_images(f"synthetic:{seed}", n_frames)
    pipe = SfmPipeline(images, calib_io.load_calibration(CALIB), SfmConfig(),
                       cache_dir=work, log=lambda *a: None)
    if not pipe._load_cache("corners"):
        raise SystemExit(f"phase b left no corner cache in {work}")
    pipe.load_map(map_b)
    problem, images_flat, H, W, _, _ = pba_refine.build_photometric_problem(
        pipe)
    pyramid = pba.build_pyramid(images_flat.reshape(-1, H, W), 3)
    prob_l, flat_l, H_l, W_l = pba_refine.level_problem(problem, pyramid, level)
    return prob_l, flat_l, H_l, W_l, pipe.model


def phase_parity(real_pipe, real_problem, phot, seed: int):
    with phase("d parity") as p:
        ce, eu, hn = geometric_step_parity(real_problem, real_pipe.model)
        p.check(hn <= STEP_REL_TOL,
                f"geometric step rel err {hn:.2e} in H-norm (tol "
                f"{STEP_REL_TOL:.0e}; Euclidean {eu:.2e}, cost {ce:.2e})")
        prob, flat, H, W, model = phot
        ce, eu, hn = photometric_step_parity(prob, model, flat, H, W, seed)
        p.check(hn <= STEP_REL_TOL,
                f"photometric step {W}x{H} rel err {hn:.2e} in H-norm (tol "
                f"{STEP_REL_TOL:.0e}; Euclidean {eu:.2e}, cost {ce:.2e})")
        bad, size = hamming_parity(real_pipe.corners)
        p.check(bad == 0, f"hamming int8-matmul vs popcount: {bad} of "
                          f"{size} entries differ")


# --------------------------------------------------------------------- e


def device_op_times(trace_dir: str):
    """{kernel name: device ns} and the busy share of the device window
    (first kernel start to last kernel end), from the ``.xplane.pb`` a
    ``jax.profiler`` trace wrote."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise SystemExit(f"no trace written under {trace_dir}")
    data = ProfileData.from_file(sorted(paths)[-1])
    planes = [pl for pl in data.planes if pl.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit("trace has no device plane: "
                         + ", ".join(pl.name for pl in data.planes))
    times: dict = {}
    spans = []
    for pl in planes:
        lines = list(pl.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if ln.name.startswith("Stream")]
        for ln in ops:
            for ev in ln.events:
                times[ev.name] = times.get(ev.name, 0.0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    spans.sort()
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return times, (busy / window if window else 0.0)


def gather_fusions(hlo_text: str) -> set:
    """Kernel names of the fusions (and bare ops) of an optimized HLO
    module that contain a ``gather``: the patch-sampling work.  XLA names
    a fusion's kernel after the fusion instruction, with '.' as '_'."""
    has_gather: dict = {}
    comp = None
    for line in hlo_text.splitlines():
        m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) \(.*\) -> .* \{$", line)
        if m:
            comp = m.group(1)
            has_gather[comp] = False
        elif line.startswith("}"):
            comp = None
        elif comp and re.search(r"\bgather\(", line):
            has_gather[comp] = True
    names = set()
    for m in re.finditer(
            r"%?([\w.\-]+) = [^\n]*?\b(fusion|gather)\(([^\n]*)", hlo_text):
        name, op, rest = m.groups()
        called = re.search(r"calls=%?([\w.\-]+)", rest)
        if op == "gather" or (called and has_gather.get(called.group(1))):
            names.update({name, name.replace(".", "_")})
    return names


def phase_trace(phot, work: str):
    import jax

    from photometric_bundle_adjustment_tpu.models import photometric_ba as pba
    from photometric_bundle_adjustment_tpu.optim import ba, fused

    with phase("e trace") as p:
        prob, flat, H, W, model = phot
        cfg = ba.BAConfig(max_iterations=3, huber_delta=9.0,
                          function_tolerance=0.0)
        solve = pba.make_fused_solver(model, flat, H, W)
        plan = fused.plan_for_problem(prob)
        run = jax.jit(lambda prob, plan: solve(prob, plan, cfg))
        run = run.lower(prob, plan).compile()
        hlo = run.as_text()
        jax.block_until_ready(run(prob, plan))                  # warm
        trace_dir = os.path.join(work, "trace")
        with jax.profiler.trace(trace_dir):
            t0 = time.time()
            _, res = run(prob, plan)
            jax.block_until_ready(res)
            wall = time.time() - t0
        p.note(f"{W}x{H}, {int(res.iterations)} LM iterations in "
               f"{1e3 * wall:.1f} ms wall under the profiler")
        times, busy = device_op_times(trace_dir)
        total = sum(times.values())
        p.check(total > 0, f"device kernel time {total / 1e6:.2f} ms, "
                           f"busy share {busy:.3f}")
        gnames = gather_fusions(hlo)
        gather = sum(t for n, t in times.items() if n in gnames)
        p.note(f"gather (sampling) fusions {gather / 1e6:.3f} ms = "
               f"{100 * gather / max(total, 1):.1f}% of device kernel time "
               f"({len(gnames) // 2} such fusions in the module)")
        top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
        p.note("top kernels " + ", ".join(
            f"{n[:60]} {t / 1e6:.2f} ms ({100 * t / total:.1f}%)"
            for n, t in top))


# ------------------------------------------------------------- multi-card


def phase_multi_card(seed: int, work: str, n_cards: int = 4):
    from photometric_bundle_adjustment_tpu.apps import pba as pba_app

    with phase("multi-card") as p:
        map_out = os.path.join(work, "map_dist.pkl")
        rc = pba_app.main([
            "--dataset-path", f"synthetic:{seed}",
            "--max-frames", str(MULTI_CARD_FRAMES),
            "--cam-calib", CALIB,
            "--distributed", str(n_cards),
            "--map-out", map_out,
        ])
        p.check(rc == 0, f"apps.pba --distributed {n_cards} exit {rc}")
        with open(map_out, "rb") as f:
            parity = pickle.load(f)["distributed_parity"]
        p.note(f"{MULTI_CARD_FRAMES} stereo pairs, {len(parity)} parity keys")
        p.check(parity["cost_rel"] <= MULTI_CARD_COST_REL_TOL,
                f"cost dist {parity['cost_dist']:.6e} vs single "
                f"{parity['cost_single']:.6e}: rel {parity['cost_rel']:.2e} "
                f"(tol {MULTI_CARD_COST_REL_TOL:.0e})")
        p.note(f"pose max|d| {parity['pose_maxdiff']:.2e}, iterations "
               f"{parity['iters_dist']} vs {parity['iters_single']}")


# -------------------------------------------------------------------- main


def count_files(path: str) -> int:
    return sum(len(files) for _, _, files in os.walk(path))


def count_compiles() -> None:
    """Count backend compiles (and their seconds) and persistent-cache
    hits and writes of this process into ``COMPILES``, from JAX's
    monitoring events."""
    from jax import monitoring

    c = COMPILES

    def on_event(event, **_):
        if event == "/jax/compilation_cache/cache_hits":
            c["hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            c["written"] += 1           # JAX counts a miss when it writes

    def on_duration(event, secs, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            c["compiles"] += 1
            c["compile_s"] += secs

    monitoring.register_event_listener(on_event)
    monitoring.register_event_duration_secs_listener(on_duration)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi-card", action="store_true",
                    help="run only the four-card distributed photometric "
                         "solve and its single-card comparison")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, PACKAGE)):
        raise SystemExit(f"{PACKAGE} is not beside {__file__}")
    sys.path.insert(0, HERE)

    from photometric_bundle_adjustment_tpu.utils.runtime import (
        configure_runtime,
    )

    cache = configure_runtime()
    count_compiles()
    n_cards = 4 if args.multi_card else 1
    devs = phase_device(n_cards)
    n_cache = count_files(cache)
    print(f"compile cache {cache}: {n_cache} files at start", flush=True)

    with tempfile.TemporaryDirectory() as work:
        if args.multi_card:
            phase_multi_card(args.seed, work, n_cards)
        else:
            map_b = phase_pipeline(args.seed, work)
            real_pipe, real_problem = phase_real_ba(args.seed)
            phot = photometric_level_problem(args.seed, work, map_b)
            phase_parity(real_pipe, real_problem, phot, args.seed)
            phase_trace(phot, work)

    n_after = count_files(cache)
    print(f"compile cache {cache}: {n_after} files at end "
          f"({n_after - n_cache} written by this run); "
          f"{COMPILES['compiles']} backend compiles took "
          f"{COMPILES['compile_s']:.1f}s; persistent cache "
          f"{COMPILES['hits']} hits, {COMPILES['written']} entries written",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
