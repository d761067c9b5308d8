"""Dissect the detection+description batch (8 images) into its stages."""
import time

import jax
import jax.numpy as jnp
import numpy as np

from photometric_bundle_adjustment_tpu.features import describe, detect
from photometric_bundle_adjustment_tpu.utils.runtime import (
    configure_runtime,
)

configure_runtime()
print("backend:", jax.default_backend())

B, H, W, F = 8, 480, 752, 1500
rng = np.random.default_rng(0)
imgs = jnp.asarray(rng.uniform(0, 255, (B, H, W)).astype(np.float32))
uv = jnp.asarray(
    np.stack([rng.uniform(20, 730, (B, F)), rng.uniform(20, 460, (B, F))],
             -1).astype(np.float32))
angles = jnp.asarray(rng.uniform(-3, 3, (B, F)).astype(np.float32))


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
    print(f"{label:40s} {(min(tns)-min(t1s))/(iters-1)*1e3:9.3f} ms")


def score_only(imgs):
    return jax.vmap(detect.shi_tomasi_score)(imgs)


def score_nms(imgs):
    s = jax.vmap(detect.shi_tomasi_score)(imgs)
    return jax.vmap(lambda x: detect._window_max2d(x, 4))(s)


def detect_full(imgs):
    return jax.vmap(lambda im: detect.detect_keypoints(im, num_features=F))(
        imgs)


def angles_only(imgs, uv):
    return jax.vmap(describe.compute_angles)(imgs, uv)


def desc_only(imgs, uv, angles):
    return jax.vmap(describe.compute_descriptors)(imgs, uv, angles)


def full(imgs):
    return describe.detect_and_describe_batch(imgs, num_features=F)


if __name__ == "__main__":
    timeit(score_only, (imgs,), "A shi-tomasi score (convs)")
    timeit(score_nms, (imgs,), "B  + window NMS")
    timeit(detect_full, (imgs,), "C detect_keypoints (incl top_k)")
    timeit(angles_only, (imgs, uv), "D compute_angles (709-tap disc)")
    timeit(desc_only, (imgs, uv, angles), "E compute_descriptors (512 taps)")
    timeit(full, (imgs,), "F full detect_and_describe_batch")
