"""True multi-process distributed smoke test.

Launches N real OS processes that join one ``jax.distributed`` job over
the CPU backend (each contributing fake devices), builds a GLOBAL mesh
spanning both processes, and runs a full distributed fused-Schur LM solve
whose psum / psum_scatter / all_gather collectives cross the process
boundary — the same code path (`parallel.dist_fused`) that a multi-host
GPU job runs over NCCL.

Run directly (the parent re-execs itself as workers):

    python scripts/multiprocess_smoke.py [--procs 2] [--devices-per-proc 2]

Worker mode (internal): MPSMOKE_RANK / MPSMOKE_NPROCS / MPSMOKE_COORD env.

Used by tests/test_multiprocess.py (marked slow) and runnable standalone;
exit code 0 = the distributed solve ran across processes and matched the
single-process result.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def worker() -> int:
    rank = int(os.environ["MPSMOKE_RANK"])
    nprocs = int(os.environ["MPSMOKE_NPROCS"])
    coord = os.environ["MPSMOKE_COORD"]
    dev_per_proc = int(os.environ.get("MPSMOKE_DEVS", "2"))

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={dev_per_proc}"
    ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")

    from photometric_bundle_adjustment_tpu.parallel import mesh as mesh_mod

    mesh_mod.initialize_multihost(
        coordinator_address=coord, num_processes=nprocs, process_id=rank
    )

    import jax.numpy as jnp
    import numpy as np

    from photometric_bundle_adjustment_tpu.models import (
        geometric_ba,
        synthetic,
    )
    from photometric_bundle_adjustment_tpu.optim import ba, fused
    from photometric_bundle_adjustment_tpu.parallel import dist_fused

    n_global = len(jax.devices())
    assert n_global == nprocs * dev_per_proc, (
        f"global device count {n_global} != {nprocs} x {dev_per_proc}"
    )
    if rank == 0:
        print(f"[rank0] global devices: {n_global} across {nprocs} processes")

    problem, _, _ = synthetic.synth_ba_problem(
        model="pinhole", K=8, L=64, obs_per_landmark=4,
        pixel_noise=0.5, dtype=jnp.float32, seed=3,
    )
    cfg = ba.BAConfig(max_iterations=4, huber_delta=1.0)
    res_fn = geometric_ba.make_residual_fn("pinhole")

    # single-device reference (local, every process computes it)
    plan = fused.plan_for_problem(problem)
    fsolve = fused.make_fused_ba_solver(res_fn, geometric_ba.cam_retract, 6)
    _, r_single = fsolve(problem, plan, cfg)

    # global-mesh distributed solve: collectives cross the process boundary
    mesh = mesh_mod.make_mesh(n_global)
    sharded = dist_fused.prepare(problem, mesh)
    dsolve = dist_fused.make_distributed_fused_solver(
        res_fn, geometric_ba.cam_retract, 6, mesh
    )
    p_dist, r_dist = dsolve(sharded, cfg)
    jax.block_until_ready(p_dist.inv_depth)

    c_s = float(jax.device_get(r_single.cost))
    c_d = float(jax.device_get(r_dist.cost))
    ok = abs(c_d - c_s) <= 1e-4 * abs(c_s) + 1e-9
    if rank == 0:
        print(
            f"[rank0] single cost {c_s:.6e} vs {nprocs}-process "
            f"distributed {c_d:.6e} -> {'OK' if ok else 'MISMATCH'}"
        )
    jax.distributed.shutdown()
    return 0 if ok else 1


def main() -> int:
    import argparse
    import socket

    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=480)
    args = ap.parse_args()

    # free port for the coordinator
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    coord = f"127.0.0.1:{port}"

    procs = []
    for rank in range(args.procs):
        env = dict(
            os.environ,
            MPSMOKE_RANK=str(rank),
            MPSMOKE_NPROCS=str(args.procs),
            MPSMOKE_COORD=coord,
            MPSMOKE_DEVS=str(args.devices_per_proc),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, os.path.abspath(__file__)],
                env=env,
                stdout=None if rank == 0 else subprocess.DEVNULL,
                stderr=subprocess.STDOUT if rank == 0 else subprocess.DEVNULL,
            )
        )
    rcs = [p.wait(timeout=args.timeout) for p in procs]
    print("worker exit codes:", rcs)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    if "MPSMOKE_RANK" in os.environ:
        sys.exit(worker())
    sys.exit(main())
