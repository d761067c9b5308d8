"""Scale stress for the distributed BA paths.

Runs synthetic problems of increasing (K cameras, L landmarks, O
observations) through the landmark-sharded fused solver on an 8-device
mesh in BOTH reduced-system modes (replicated Cholesky vs camera-row-
partitioned matrix-free PCG), records wall time and the analytic
per-device memory footprint, and prints a table.

The GSPMD `dist_ba` path materialises a dense (K, L, C) H_cp and is NOT
run here — at K=1024, L=100k that array alone is 2.4 TB; large problems
route through `dist_fused` (this is by design; dist_ba remains the
readable GSPMD reference formulation for small/medium maps).

Per-device memory model (f32 words, D devices, C = camera tangent dim):
  observations:  O/D rows x (R*(2C+1) Jacobian + aux)     [build transient]
  landmark axis: L/D x (C + 3) reduction outputs + M: L/D x K*C
  reduced system:
    replicated:   K^2 C^2 (H_cc) + K^2 C^2 (S_corr0) + Cholesky factor
    partitioned:  K^2 C^2 / D row slice (+ K^2 C^2 assembly transient;
                  no S_corr0, no factor)

Usage: python scripts/scale_stress.py [--sizes small|medium|large|all]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.models import geometric_ba, synthetic
from photometric_bundle_adjustment_tpu.optim import ba
from photometric_bundle_adjustment_tpu.parallel import dist_fused
from photometric_bundle_adjustment_tpu.parallel import mesh as mesh_mod

SIZES = {
    "small": (200, 8_192, 6),
    "medium": (512, 32_768, 8),
    "large": (1024, 98_304, 10),   # ~1M observations
}


def mem_model(K, L, O, D, C=6, R=2):
    W = R * (2 * C + 1)
    build = O // D * (W + 8)                      # Jacobians + aux rows
    m_mat = (L // D) * K * C
    rep = 2 * K * K * C * C + K * K * C * C       # H_cc + S_corr0 + factor
    part = K * K * C * C // D + K * K * C * C     # rows + assembly transient
    return {
        "build_MB": build * 4 / 1e6,
        "M_MB": m_mat * 4 / 1e6,
        "replicated_MB": rep * 4 / 1e6,
        "partitioned_MB": part * 4 / 1e6,
    }


def run_one(K, L, obs_per_lm, mode, iters=2):
    problem, _, _ = synthetic.synth_ba_problem(
        model="pinhole", K=K, L=L, obs_per_landmark=obs_per_lm,
        pixel_noise=0.5, dtype=jnp.float32,
    )
    O = problem.obs.anchor_cam.shape[0]
    cfg = ba.BAConfig(max_iterations=iters, huber_delta=1.0)
    res_fn = geometric_ba.make_residual_fn("pinhole")
    mesh = mesh_mod.make_mesh(8)
    t0 = time.time()
    sharded = dist_fused.prepare(problem, mesh)
    t_prep = time.time() - t0
    dsolve = dist_fused.make_distributed_fused_solver(
        res_fn, geometric_ba.cam_retract, 6, mesh,
        camera_partition=(mode == "partitioned"), n_cg=300, cg_tol=1e-7,
    )
    t0 = time.time()
    p, r = dsolve(sharded, cfg)
    jax.block_until_ready(p.inv_depth)
    t_solve = time.time() - t0
    ok = bool(np.isfinite(float(r.cost))) and float(r.cost) < float(
        r.initial_cost
    )
    cg = int(np.asarray(r.cg_iterations))
    return O, t_prep, t_solve, float(r.initial_cost), float(r.cost), ok, cg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="all")
    ap.add_argument("--iters", type=int, default=2)
    args = ap.parse_args()
    names = list(SIZES) if args.sizes == "all" else [args.sizes]

    print(f"{'size':>8} {'K':>5} {'L':>7} {'O':>8} {'mode':>12} "
          f"{'prep_s':>7} {'solve_s':>8} {'cost':>22} {'ok':>3} {'cg':>5}")
    for name in names:
        K, L, opl = SIZES[name]
        for mode in ("replicated", "partitioned"):
            O, tp, ts, c0, c1, ok, cg = run_one(K, L, opl, mode, args.iters)
            print(f"{name:>8} {K:>5} {L:>7} {O:>8} {mode:>12} "
                  f"{tp:>7.1f} {ts:>8.1f} {c0:>10.3e}->{c1:<10.3e} "
                  f"{'Y' if ok else 'N'} {cg:>5}")
        mm = mem_model(K, L, O, 8)
        print(f"{'':>8} per-device MB: build={mm['build_MB']:.0f} "
              f"M={mm['M_MB']:.0f} reduced(repl)={mm['replicated_MB']:.0f} "
              f"reduced(part)={mm['partitioned_MB']:.0f}")


if __name__ == "__main__":
    main()
