"""Sub-profile five_point_candidates at RANSAC batch scale (4096 samples)."""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp, numpy as np
from photometric_bundle_adjustment_tpu.features import nister
from photometric_bundle_adjustment_tpu.utils.runtime import configure_runtime
configure_runtime()
print("backend:", jax.default_backend())

B = 4096
rng = np.random.default_rng(0)
f0 = rng.normal(size=(B, 5, 3)); f0 /= np.linalg.norm(f0, axis=-1, keepdims=True)
f1 = rng.normal(size=(B, 5, 3)); f1 /= np.linalg.norm(f1, axis=-1, keepdims=True)
f0 = jnp.asarray(f0.astype(np.float32)); f1 = jnp.asarray(f1.astype(np.float32))

def timeloop(fn, args, iters=8, label=""):
    def run(n, a):
        def body(s, acc):
            pert = jax.tree_util.tree_map(
                lambda x: x + (acc * 1e-30).astype(x.dtype), a)
            out = fn(*pert)
            leaves = [jnp.sum(x).astype(jnp.float32)
                      for x in jax.tree_util.tree_leaves(out)
                      if jnp.issubdtype(x.dtype, jnp.floating)]
            return acc + sum(leaves)
        return jax.lax.fori_loop(0, n, body, jnp.asarray(0.0, jnp.float32))
    rn = jax.jit(lambda a: run(iters, a)); r1 = jax.jit(lambda a: run(1, a))
    float(rn(args)); float(r1(args))
    tns, t1s = [], []
    for _ in range(3):
        t0 = time.time(); float(rn(args)); tns.append(time.time() - t0)
        t0 = time.time(); float(r1(args)); t1s.append(time.time() - t0)
    print(f"{label:30s} {(min(tns)-min(t1s))/(iters-1)*1e3:8.1f} ms/batch")

def stage_svd(f0, f1):
    Q = jnp.einsum("bni,bnj->bnij", f0, f1).reshape(B, 5, 9)
    _, _, Vt = jnp.linalg.svd(Q, full_matrices=True)
    return Vt[:, 5:9][:, ::-1].reshape(B, 4, 3, 3)
timeloop(stage_svd, (f0, f1), label="1 nullspace SVD")

Eb = stage_svd(f0, f1)
timeloop(jax.vmap(nister._constraint_matrix), (Eb,), label="2 constraint matrix")
A = jax.vmap(nister._constraint_matrix)(Eb)
timeloop(jax.vmap(nister._action_polynomials), (A,), label="3 action polys (2x10x10 solve)")
_, _, det = jax.vmap(nister._action_polynomials)(A)
timeloop(jax.vmap(lambda d: nister.real_roots(d, 10)), (det,), label="4 real_roots (48 bisect)")
timeloop(jax.vmap(lambda d: nister.real_roots(d, 10, 512, 24)), (det,), label="4b real_roots (24 bisect)")
timeloop(jax.vmap(nister.five_point_candidates), (f0, f1), label="5 full five_point")
