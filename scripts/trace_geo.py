"""Capture a jax.profiler trace of the v2 geo build+solve and summarize."""
import glob
import gzip
import json
import os

import jax
import jax.numpy as jnp

from photometric_bundle_adjustment_tpu.models import geometric_ba, synthetic
from photometric_bundle_adjustment_tpu.optim import ba, fused
from photometric_bundle_adjustment_tpu.ops import geo_mega
from photometric_bundle_adjustment_tpu.utils.runtime import (
    configure_runtime,
)

configure_runtime()
model = "pinhole"
problem, _, _ = synthetic.synth_ba_problem(
    model=model, K=200, L=8192, obs_per_landmark=6, pixel_noise=0.3,
    dtype=jnp.float32,
)
problem, plan = fused.densify_problem(problem, pow2_buckets=False)
cfg = ba.BAConfig(max_iterations=1, huber_delta=1.0,
                  schur_matmul_precision="high")
g2 = geo_mega.make_geo_solver(model, problem, plan_slot=plan)
consts = g2.consts
lam = jnp.asarray(1e-4, jnp.float32)


def step(problem):
    with jax.default_matmul_precision("float32"):
        cost, neq = geo_mega.build_geo_dense2(model, problem, consts, plan,
                                              cfg)
        dc, dp = geo_mega.solve_lam2(neq, lam, ~problem.fixed_cams, cfg)
        new_cams = jax.vmap(geometric_ba.cam_retract)(problem.cam_states, dc)
        return problem._replace(
            cam_states=new_cams, inv_depth=problem.inv_depth + dp
        ), cost


jstep = jax.jit(step)
out = jstep(problem)
float(out[1])

logdir = "/tmp/geo_trace"
os.system(f"rm -rf {logdir}")
jax.profiler.start_trace(logdir)
for _ in range(5):
    out = jstep(out[0])
    float(out[1])
jax.profiler.stop_trace()

paths = glob.glob(f"{logdir}/**/*.trace.json.gz", recursive=True)
print("trace files:", paths)
ev_by_name = {}
for p in paths:
    with gzip.open(p, "rt") as f:
        data = json.load(f)
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "X" and "dur" in ev:
            name = ev.get("name", "")
            ev_by_name.setdefault(name, [0, 0.0])
            ev_by_name[name][0] += 1
            ev_by_name[name][1] += ev["dur"]
rows = sorted(ev_by_name.items(), key=lambda kv: -kv[1][1])
tot = 0.0
for name, (n, dur) in rows[:60]:
    print(f"{dur/5:10.1f} us  x{n:4d}  {name[:110]}")
