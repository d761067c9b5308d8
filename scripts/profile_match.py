"""Dissect the all-pairs matching chunk: time each sub-stage of make_pair_matcher at the exact bench shapes
(C=32 pairs, F=512 features, 128 hypotheses) to find where the time goes.

Run on the GPU (or CPU for the baseline breakdown).
"""
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.features import (
    geometry, match, nister, pair_matching, ransac,
)
from photometric_bundle_adjustment_tpu.utils.runtime import (
    configure_runtime,
)

configure_runtime()
print("backend:", jax.default_backend())

I, F, C, MM, HYP = 164, 512, 32, 512, 128
rng = np.random.default_rng(0)
desc = jnp.asarray(rng.integers(0, 2**32, (I, F, 8), dtype=np.uint32))
valid = jnp.ones((I, F), bool)
b = rng.normal(size=(I, F, 3))
b[..., 2] = np.abs(b[..., 2]) + 0.5
bearings = jnp.asarray(
    (b / np.linalg.norm(b, axis=-1, keepdims=True)).astype(np.float32)
)
key = jax.random.PRNGKey(0)
lane = jnp.arange(C, dtype=jnp.int32)


def timeit(make_body, label, iters=8):
    """make_body(s) -> scalar contribution; timed in one fori_loop."""

    def run(n):
        def body(s, acc):
            return acc + make_body(s)

        return jax.lax.fori_loop(0, n, body, jnp.asarray(0.0, jnp.float32))

    run_n = jax.jit(lambda: run(iters))
    run_1 = jax.jit(lambda: run(1))
    float(run_n()); float(run_1())
    t_ns, t_1s = [], []
    for _ in range(3):
        t0 = time.time(); float(run_n()); t_ns.append(time.time() - t0)
        t0 = time.time(); float(run_1()); t_1s.append(time.time() - t0)
    dt = (min(t_ns) - min(t_1s)) / (iters - 1)
    print(f"{label:44s} {dt*1e3:9.3f} ms/chunk")
    return dt


def pair_idx(s):
    i1 = (lane * 7 + s) % I
    i2 = (lane * 11 + 2 * s + 1) % I
    return i1, i2


# ---- stage A: Hamming best-2 both ways + accept + cross-check ----
def stage_match(s):
    i1, i2 = pair_idx(s)

    def one(a, b_):
        m12 = match.match_descriptors(
            desc[a], desc[b_], valid[a], valid[b_], 70, 1.2
        )
        return jnp.sum(m12).astype(jnp.float32)

    return jnp.sum(jax.vmap(one)(i1, i2))


# ---- stage B: + compaction ----
def stage_compact(s):
    i1, i2 = pair_idx(s)

    def one(a, b_):
        m12 = match.match_descriptors(
            desc[a], desc[b_], valid[a], valid[b_], 70, 1.2
        )
        pairs, pvalid, count = match.matches_to_pairs(m12, MM)
        return jnp.sum(pairs).astype(jnp.float32) + count.astype(jnp.float32)

    return jnp.sum(jax.vmap(one)(i1, i2))


# ---- stage C: nister candidates only (fixed random samples) ----
bsamp0 = jnp.asarray(rng.normal(size=(C, HYP, 5, 3)).astype(np.float32))
bsamp0 = bsamp0 / jnp.linalg.norm(bsamp0, axis=-1, keepdims=True)
bsamp1 = bsamp0 + 0.01


def stage_nister(s):
    x0 = bsamp0 + s * 1e-30
    Es, ev = jax.vmap(jax.vmap(nister.five_point_candidates))(x0, bsamp1)
    return jnp.sum(Es).astype(jnp.float32)


# ---- full RANSAC at various refine_iters ----
def make_full(refine_iters):
    def full(s):
        i1, i2 = pair_idx(s)

        def one(a, b_, k):
            m12 = match.match_descriptors(
                desc[a], desc[b_], valid[a], valid[b_], 70, 1.2
            )
            pairs, pvalid, count = match.matches_to_pairs(m12, MM)
            b0 = bearings[a][pairs[:, 0]]
            b1 = bearings[b_][pairs[:, 1]]
            T, inl, n_inl = ransac.ransac_relative_pose(
                b0, b1, pvalid, k, threshold=5e-5, min_inliers=16,
                num_hypotheses=HYP, refine_iters=refine_iters,
            )
            return jnp.sum(T).astype(jnp.float32)

        keys = jax.random.split(jax.random.fold_in(key, s), C)
        return jnp.sum(jax.vmap(one)(i1, i2, keys))

    return full


if __name__ == "__main__":
    timeit(stage_match, "A hamming+accept+crosscheck")
    timeit(stage_compact, "B  + compaction (argsort)")
    timeit(stage_nister, "C nister 5pt candidates (128 hyp)")
    timeit(make_full(0), "D full chunk, refine_iters=0")
    timeit(make_full(3), "E full chunk, refine_iters=3")
    timeit(make_full(10), "F full chunk, refine_iters=10 (bench)")
