"""Keypoint orientation + rotated BRIEF-256 descriptors, batched.

Replaces computeAngles / computeDescriptors (include/visnav/keypoints.h:
151-213): intensity-centroid orientation over the radius-15 disc, then the
256 hard-coded sampling pairs rotated by the angle (with the same
``round()`` quantisation as the reference so descriptors are bit-compatible)
and compared.  One gather of shape (N, taps) per image instead of scalar
loops; descriptors are packed into (N, 8) uint32 words so matching can use
XOR + population-count on 32-bit lanes.

The sampling-pair table is the standard ORB pattern, shipped as data in
``brief_pattern.npz``.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

PATCH_SIZE = 31       # keypoints.h:49
HALF_PATCH_SIZE = 15  # keypoints.h:50

_pattern = np.load(os.path.join(os.path.dirname(__file__), "brief_pattern.npz"))
PATTERN_XA = jnp.asarray(_pattern["xa"], jnp.float32)
PATTERN_YA = jnp.asarray(_pattern["ya"], jnp.float32)
PATTERN_XB = jnp.asarray(_pattern["xb"], jnp.float32)
PATTERN_YB = jnp.asarray(_pattern["yb"], jnp.float32)

# circular-disc offsets for the intensity centroid (keypoints.h:167-173):
# for x in [-15, 15], y in [-floor(sqrt(15^2 - x^2)), +floor(...)]
_disc = []
for _x in range(-HALF_PATCH_SIZE, HALF_PATCH_SIZE + 1):
    _yb = int(np.sqrt(HALF_PATCH_SIZE * HALF_PATCH_SIZE - _x * _x))
    for _y in range(-_yb, _yb + 1):
        _disc.append((_x, _y))
DISC_OFFSETS = jnp.asarray(np.array(_disc, np.int32))  # (D, 2) as (x, y)


def _gather_pixels(img: jax.Array, x: jax.Array, y: jax.Array) -> jax.Array:
    """img[(y, x)] with clamping; img is (H, W), x/y int arrays."""
    H, W = img.shape
    xc = jnp.clip(x, 0, W - 1)
    yc = jnp.clip(y, 0, H - 1)
    return img[yc, xc]


def _shifted(m: jax.Array, axis: int, o: int, r: int) -> jax.Array:
    """Zero-padded shift: out(p) = m(p + o along axis), |o| <= r."""
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    xp = jnp.pad(m, pad)
    sl = [slice(None), slice(None)]
    sl[axis] = slice(r + o, r + o + m.shape[axis])
    return xp[tuple(sl)]


def centroid_moment_maps(img: jax.Array):
    """Dense intensity-centroid moments over the radius-15 disc: (H, W)
    maps m10(p) = sum_disc dx * I(p + d), m01 analogously.

    The per-keypoint formulation gathered 709 disc taps per corner
    (8.5 M scalar gathers per 8-image batch); computing the moments
    densely needs ~120 fused shift-adds and then TWO gathers per
    corner.  The integer disc {x^2 + y^2 <= 225} is symmetric, so the
    column (row) extent at offset d is yb(d) = floor(sqrt(225 - d^2)) in
    both orientations; centered box sums are built incrementally over the
    half-height.  Out-of-image taps read as zero (the reference's corners
    are >= EDGE_THRESHOLD = 19 px from the border, so no real corner is
    affected)."""
    img = img.astype(jnp.float32)
    R = HALF_PATCH_SIZE
    yb = [int(np.sqrt(R * R - d * d)) for d in range(R + 1)]

    def centered_boxes(axis):
        """{b: sum of shifts -b..b along axis} built incrementally."""
        out = {0: img}
        acc = img
        for b in range(1, R + 1):
            acc = acc + _shifted(img, axis, b, R) + _shifted(img, axis, -b, R)
            out[b] = acc
        return out

    colbox = centered_boxes(0)  # vertical extent (for m10's dx columns)
    rowbox = centered_boxes(1)  # horizontal extent (for m01's dy rows)
    m10 = jnp.zeros_like(img)
    m01 = jnp.zeros_like(img)
    for d in range(1, R + 1):
        cb = colbox[yb[d]]
        m10 = m10 + d * (_shifted(cb, 1, d, R) - _shifted(cb, 1, -d, R))
        rb = rowbox[yb[d]]
        m01 = m01 + d * (_shifted(rb, 0, d, R) - _shifted(rb, 0, -d, R))
    return m10, m01


@jax.jit
def compute_angles(img: jax.Array, uv: jax.Array) -> jax.Array:
    """Intensity-centroid orientation, (N,) radians (keypoints.h:151-180)."""
    m10, m01 = centroid_moment_maps(img)
    cx = uv[:, 0].astype(jnp.int32)  # truncation, as the reference's int cast
    cy = uv[:, 1].astype(jnp.int32)
    return jnp.arctan2(_gather_pixels(m01, cx, cy),
                       _gather_pixels(m10, cx, cy))


@jax.jit
def compute_descriptors(
    img: jax.Array, uv: jax.Array, angles: jax.Array
) -> jax.Array:
    """Rotated BRIEF-256, packed to (N, 8) uint32 (keypoints.h:182-213)."""
    img = img.astype(jnp.float32)
    cx = uv[:, 0].astype(jnp.int32)
    cy = uv[:, 1].astype(jnp.int32)
    ca = jnp.cos(angles)[:, None]  # (N, 1)
    sa = jnp.sin(angles)[:, None]

    def rot_round(px, py):
        rx = jnp.round(ca * px[None, :] - sa * py[None, :]).astype(jnp.int32)
        ry = jnp.round(sa * px[None, :] + ca * py[None, :]).astype(jnp.int32)
        return rx, ry

    xa, ya = rot_round(PATTERN_XA, PATTERN_YA)
    xb, yb = rot_round(PATTERN_XB, PATTERN_YB)
    va = _gather_pixels(img, cx[:, None] + xa, cy[:, None] + ya)
    vb = _gather_pixels(img, cx[:, None] + xb, cy[:, None] + yb)
    bits = (va < vb).astype(jnp.uint32)  # (N, 256)

    # pack bit d of word w = bits[:, 32*w + d] << d
    N = bits.shape[0]
    words = bits.reshape(N, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


def detect_and_describe(img, num_features=1500, rotate_features=True):
    """Full front-end for one image: corners + angles + descriptors.

    Mirrors detectKeypointsAndDescriptors (keypoints.h:215-221).  Returns
    (uv (F,2), valid (F,), angles (F,), descriptors (F,8) uint32).
    """
    from photometric_bundle_adjustment_tpu.features.detect import detect_keypoints

    uv, valid, _ = detect_keypoints(img, num_features=num_features)
    if rotate_features:
        angles = compute_angles(img, uv)
    else:
        angles = jnp.zeros(uv.shape[0], jnp.float32)
    desc = compute_descriptors(img, uv, angles)
    return uv, valid, angles, desc


@functools.partial(
    jax.jit, static_argnames=("num_features", "rotate_features")
)
def detect_and_describe_batch(
    imgs: jax.Array, num_features: int = 1500, rotate_features: bool = True
):
    """Batched front-end over a stack of images (B, H, W): one compiled
    program instead of 3B dispatches."""
    from photometric_bundle_adjustment_tpu.features.detect import detect_keypoints

    def one(img):
        uv, valid, _ = detect_keypoints(img, num_features=num_features)
        if rotate_features:
            angles = compute_angles(img, uv)
        else:
            angles = jnp.zeros(uv.shape[0], jnp.float32)
        desc = compute_descriptors(img, uv, angles)
        return uv, valid, angles, desc

    return jax.vmap(one)(imgs)


@functools.partial(
    jax.jit, static_argnames=("batch", "num_features", "rotate_features")
)
def detect_and_describe_all(
    imgs: jax.Array, batch: int = 8, num_features: int = 1500,
    rotate_features: bool = True,
):
    """Whole-dataset front-end in ONE dispatch: ``lax.map`` over
    vmapped sub-batches of ``batch`` images.

    One host->device upload of the image stack and one fetch of all
    features replace per-batch round trips.  Memory stays at one
    sub-batch's conv/NMS intermediates: ~(batch, H, W) f32 maps, not
    (N, H, W).

    imgs: (N, H, W) with N a multiple of ``batch`` (pad with zero images;
    their corners come back invalid).
    """
    N = imgs.shape[0]
    if N % batch != 0:
        raise ValueError(f"image count {N} not a multiple of batch {batch}")
    stacked = imgs.reshape((N // batch, batch) + imgs.shape[1:])

    def step(sub):
        return detect_and_describe_batch(
            sub, num_features=num_features, rotate_features=rotate_features
        )

    uv, valid, angles, desc = jax.lax.map(step, stacked)
    flat = lambda x: x.reshape((N,) + x.shape[2:])
    return flat(uv), flat(valid), flat(angles), flat(desc)
