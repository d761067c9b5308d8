"""Accuracy of HIGH (TF32 on the GPU) vs HIGHEST for the Schur correction
and the resulting LM step, on the default backend."""
import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.models import geometric_ba, synthetic
from photometric_bundle_adjustment_tpu.optim import ba, fused
from photometric_bundle_adjustment_tpu.utils.runtime import configure_runtime

configure_runtime()
print("backend:", jax.default_backend())
problem, _, _ = synthetic.synth_ba_problem(
    model="pinhole", K=200, L=8192, obs_per_landmark=6, pixel_noise=0.3,
    dtype=jnp.float32,
)
cfg = ba.BAConfig(max_iterations=1, huber_delta=1.0)
residual_fn = geometric_ba.make_residual_fn("pinhole")
solver = fused.make_fused_ba_solver(residual_fn, geometric_ba.cam_retract, 6)
plan = fused.plan_for_problem(problem, pow2_buckets=False)
lam = jnp.asarray(1e-4, jnp.float32)
free = ~problem.fixed_cams


def step(p, prec):
    with jax.default_matmul_precision(prec):
        cost, neq = solver.build(p, plan, cfg)
        dc, dp = solver.solve_lam(neq, plan, lam, free, cfg)
    return cost, dc, dp, neq[1]


hi = jax.jit(lambda p: step(p, "float32"))(problem)
md = jax.jit(lambda p: step(p, "tensorfloat32"))(problem)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


print("cost rel:", rel(md[0], hi[0]))
print("S_corr rel:", rel(md[3], hi[3]))
print("dc rel:", rel(md[1], hi[1]))
print("dp rel:", rel(md[2], hi[2]))
print("dc scale:", float(np.abs(np.asarray(hi[1])).max()))
