"""Split the matching-chunk device time: Hamming vs 5-point vs LM refine.

Matching may be op-latency/serial-loop bound rather than FLOP bound.
This isolates the pieces
at chunk scale (C=32 pairs, F=512 features, H=128 hypotheses).
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax, jax.numpy as jnp, numpy as np
from photometric_bundle_adjustment_tpu.features import match, ransac, nister
from photometric_bundle_adjustment_tpu.utils.runtime import configure_runtime
configure_runtime()
print("backend:", jax.default_backend())

rng = np.random.default_rng(0)
I, F, C, MM, H = 164, 512, 32, 512, 128
desc = jnp.asarray(rng.integers(0, 2**32, (I, F, 8), dtype=np.uint32))
valid = jnp.ones((I, F), bool)
b = rng.normal(size=(I, F, 3)); b[..., 2] = np.abs(b[..., 2]) + 0.5
bear = jnp.asarray((b / np.linalg.norm(b, axis=-1, keepdims=True)).astype(np.float32))
key = jax.random.PRNGKey(0); lane = jnp.arange(C, dtype=jnp.int32)

def timeloop(fn, iters=8, label=""):
    def run(n):
        def body(s, acc):
            out = fn(s)
            leaves = [jnp.sum(x).astype(jnp.float32)
                      for x in jax.tree_util.tree_leaves(out)
                      if jnp.issubdtype(x.dtype, jnp.floating)]
            return acc + sum(leaves)
        return jax.lax.fori_loop(0, n, body, jnp.asarray(0.0, jnp.float32))
    rn = jax.jit(lambda: run(iters)); r1 = jax.jit(lambda: run(1))
    float(rn()); float(r1())
    tns, t1s = [], []
    for _ in range(3):
        t0 = time.time(); float(rn()); tns.append(time.time() - t0)
        t0 = time.time(); float(r1()); t1s.append(time.time() - t0)
    dt = (min(tns) - min(t1s)) / (iters - 1)
    print(f"{label:34s} {dt*1e3:8.1f} ms/chunk  {dt/C*1e3:6.2f} ms/pair")
    return dt

def pair_idx(s):
    return (lane * 7 + s) % I, (lane * 11 + 2 * s + 1) % I

def hamming_only(s):
    i1, i2 = pair_idx(s)
    def one(a, b2):
        m12 = match.match_descriptors(desc[a], desc[b2], valid[a], valid[b2], 70, 1.2)
        return match.matches_to_pairs(m12, MM)
    return jax.vmap(one)(i1, i2)
timeloop(hamming_only, label="hamming + compaction")

def fivept_only(s):
    i1, i2 = pair_idx(s)
    k = jax.random.fold_in(key, s)
    def one(a, b2, kk):
        idx = ransac._sample_indices(kk, H, 5, valid[a])
        return nister.five_point_candidates(bear[a][idx[0]], bear[b2][idx[0]])
    # one sample per pair x H via reshape: solve C*H samples batched
    idx = jax.vmap(lambda kk, v: ransac._sample_indices(kk, H, 5, v))(
        jax.random.split(k, C), valid[i1])
    f0 = bear[i1[:, None, None], idx]    # (C, H, 5, 3)
    f1 = bear[i2[:, None, None], idx]
    Es, ev = jax.vmap(jax.vmap(nister.five_point_candidates))(f0, f1)
    return Es
timeloop(fivept_only, label="5-point candidates (C*H samples)")

def full_ransac(s, refine):
    i1, i2 = pair_idx(s)
    k = jax.random.fold_in(key, s)
    def one(a, b2, kk):
        return ransac.ransac_relative_pose(
            bear[a], bear[b2], valid[a], kk,
            num_hypotheses=H, refine_iters=refine)
    return jax.vmap(one)(i1, i2, jax.random.split(k, C))
timeloop(lambda s: full_ransac(s, 0), label="ransac refine_iters=0")
timeloop(lambda s: full_ransac(s, 10), label="ransac refine_iters=10")
