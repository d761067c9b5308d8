"""Dissect the PnP-localization kernel (the composite's 4.1 s stage:
249 calls x 1024-row bucket x 512 P3P hypotheses + 2 LO rounds)."""
import time

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.features import p3p as p3p_mod
from photometric_bundle_adjustment_tpu.features import ransac
from photometric_bundle_adjustment_tpu.pipeline import sfm_pipeline as sp
from photometric_bundle_adjustment_tpu.utils.runtime import (
    configure_runtime,
)

configure_runtime()
print("backend:", jax.default_backend())

M, HYP = 1024, 512
rng = np.random.default_rng(0)
intr = jnp.asarray(
    np.array([458.0, 457.0, 376.0, 240.0, 0, 0, 0, 0], np.float32)
)
uv = jnp.asarray(np.stack([rng.uniform(20, 730, M),
                           rng.uniform(20, 460, M)], -1).astype(np.float32))
pts = jnp.asarray(rng.normal(0, 2.0, (M, 3)).astype(np.float32)
                  + np.array([0, 0, 6.0], np.float32))
valid = jnp.ones(M, bool)
key = jax.random.PRNGKey(1)

b = rng.normal(size=(M, 3))
b[:, 2] = np.abs(b[:, 2]) + 0.5
bearings = jnp.asarray((b / np.linalg.norm(b, -1, keepdims=True))
                       .astype(np.float32))


def timeit(fn, args, label, iters=16):
    def run(n, a):
        def body(s, acc):
            pert = jax.tree_util.tree_map(
                lambda x: x + (acc * 1e-30).astype(x.dtype)
                if jnp.issubdtype(x.dtype, jnp.floating) else x, a)
            out = fn(*pert)
            leaves = [jnp.sum(x).astype(jnp.float32)
                      for x in jax.tree_util.tree_leaves(out)
                      if jnp.issubdtype(x.dtype, jnp.floating)]
            return acc + sum(leaves)
        return jax.lax.fori_loop(0, n, body, jnp.asarray(0.0, jnp.float32))

    rn = jax.jit(lambda a: run(iters, a))
    r1 = jax.jit(lambda a: run(1, a))
    float(rn(args)); float(r1(args))
    tns, t1s = [], []
    for _ in range(3):
        t0 = time.time(); float(rn(args)); tns.append(time.time() - t0)
        t0 = time.time(); float(r1(args)); t1s.append(time.time() - t0)
    print(f"{label:42s} {(min(tns)-min(t1s))/(iters-1)*1e3:9.3f} ms")


def full(uv, pts):
    return sp._localize_kernel("pinhole", uv, intr, pts, valid, key,
                               3.0, HYP)


def p3p_only(bearings, pts):
    idx = ransac._sample_indices(key, HYP, 3, valid)
    Rs, ts, pvalid = jax.vmap(p3p_mod.p3p_candidates)(
        bearings[idx], pts[idx])
    return Rs, ts


def ransac_lo0(bearings, pts):
    return ransac.ransac_pnp(bearings, pts, valid, key,
                             num_hypotheses=HYP, lo_rounds=0,
                             refine_iters=0)


def ransac_lo2_r0(bearings, pts):
    return ransac.ransac_pnp(bearings, pts, valid, key,
                             num_hypotheses=HYP, lo_rounds=2,
                             refine_iters=2)


if __name__ == "__main__":
    timeit(p3p_only, (bearings, pts), "A p3p candidates (512 hyp)")
    timeit(ransac_lo0, (bearings, pts), "B ransac lo_rounds=0 (no refine)")
    timeit(ransac_lo2_r0, (bearings, pts), "C ransac lo=2, refine_iters=2")
    timeit(full, (uv, pts), "D full kernel (lo=2, refine=10)")
