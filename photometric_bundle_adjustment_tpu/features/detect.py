"""Shi-Tomasi corner detection.

Replaces the reference's ``cv::goodFeaturesToTrack`` call
(include/visnav/keypoints.h:133-149): Sobel gradients -> structure tensor
(box filter) -> minimum-eigenvalue score -> quality threshold (fraction of
the max score) -> non-maximum suppression -> top-k.  All filters run as
zero-padded separable shift-multiply-adds (a single-channel
``conv_general_dilated`` would spend a matrix unit on one channel);
shapes are static (fixed ``num_features`` slots with a validity mask) so
the whole front-end jits.

The greedy min-distance NMS of OpenCV is replaced by window NMS (a corner
survives iff it is the maximum of its (2r+1)^2 neighbourhood with
r = min_distance // 2) followed by score-ordered top-k.  Measured
selection overlap against cv2.goodFeaturesToTrack on a real EuRoC frame
(tests/test_features.py::test_detect_overlap_vs_opencv): 91% of OpenCV's
corners have one of ours within 2 px, and 100% of our corners lie within
8 px (= min_distance) of an OpenCV corner.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

EDGE_THRESHOLD = 19  # keypoints.h:51


def conv1d_shift(x: jax.Array, taps, axis: int) -> jax.Array:
    """Zero-padded 1-D correlation along ``axis`` of a 2-D map, as an
    unrolled shift-multiply-add over ``taps`` [(offset, weight), ...].

    Single-channel ``conv_general_dilated`` pads the feature dimension to
    a matrix tile and wastes most of it; shifted elementwise maths runs at
    memory bandwidth and fuses with its neighbours.
    out(p) = sum_k w_k * x(p + o_k along axis).
    """
    r = max(abs(o) for o, _ in taps)
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    xp = jnp.pad(x, pad)
    n = x.shape[axis]
    out = None
    for o, w in taps:
        sl = [slice(None), slice(None)]
        sl[axis] = slice(r + o, r + o + n)
        term = w * xp[tuple(sl)]
        out = term if out is None else out + term
    return out


def shi_tomasi_score(img: jax.Array, block_size: int = 3) -> jax.Array:
    """Min-eigenvalue corner response (H, W).

    Sobel and box filters are separable; each factor runs as a
    zero-padded shift-add pass (identical result to the zero-padded 2-D
    convolutions, including borders, since the 2-D kernels are outer
    products)."""
    img = img.astype(jnp.float32)
    smooth = [(-1, 0.25), (0, 0.5), (1, 0.25)]   # [1, 2, 1] / 4
    diff = [(-1, -0.5), (1, 0.5)]                # [-1, 0, 1] / 2
    # sobel/8 = smooth/4 (cross axis) * diff/2 (grad axis)
    ix = conv1d_shift(conv1d_shift(img, smooth, 0), diff, 1)
    iy = conv1d_shift(conv1d_shift(img, smooth, 1), diff, 0)
    r = block_size // 2
    box = [(o, 1.0) for o in range(-r, r + 1)]
    ixx = conv1d_shift(conv1d_shift(ix * ix, box, 0), box, 1)
    iyy = conv1d_shift(conv1d_shift(iy * iy, box, 0), box, 1)
    ixy = conv1d_shift(conv1d_shift(ix * iy, box, 0), box, 1)
    tr = ixx + iyy
    det_part = jnp.sqrt(jnp.maximum((ixx - iyy) ** 2 + 4.0 * ixy * ixy, 0.0))
    return 0.5 * (tr - det_part)


def _window_max2d(score: jax.Array, r: int) -> jax.Array:
    """Sliding (2r+1)^2 max of a non-negative (H, W) map via separable
    shifted maxima (no lax.reduce_window — see NMS comment below)."""

    def axis_max(x, axis):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        xp = jnp.pad(x, pad)
        n = x.shape[axis]
        out = x
        for s in range(2 * r + 1):
            if s == r:
                continue
            sl = [slice(None), slice(None)]
            sl[axis] = slice(s, s + n)
            out = jnp.maximum(out, xp[tuple(sl)])
        return out

    return axis_max(axis_max(score, 0), 1)


@functools.partial(
    jax.jit, static_argnames=("num_features", "min_distance", "edge_threshold")
)
def detect_keypoints(
    img: jax.Array,
    num_features: int = 1500,
    quality_level: float = 0.01,
    min_distance: int = 8,
    edge_threshold: int = EDGE_THRESHOLD,
):
    """Detect up to ``num_features`` corners.

    Args:
      img: (H, W) grayscale (uint8 or float).

    Returns:
      uv: (num_features, 2) float32 corner positions (x=col, y=row), padded.
      valid: (num_features,) bool.
      score: (num_features,) float32.

    Defaults match sfm.cpp:197-198 (1500 features) and
    goodFeaturesToTrack(quality 0.01, min dist 8) at keypoints.h:138,
    with the edge-margin filter of keypoints.h:145.
    """
    H, W = img.shape
    score = shi_tomasi_score(img)

    # edge margin FIRST (InBounds with EDGE_THRESHOLD, keypoints.h:145):
    # the zero-padded convolutions manufacture huge phantom responses on
    # the image border; if they enter the max, the relative quality gate
    # wipes out real corners on low-contrast (blurred) frames — measured
    # 28 vs OpenCV's 369 corners on EuRoC V1 frame 47 before this fix.
    ys = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_bounds = (
        (xs >= edge_threshold)
        & (xs < W - edge_threshold)
        & (ys >= edge_threshold)
        & (ys < H - edge_threshold)
    )
    score = jnp.where(in_bounds, score, 0.0)

    # quality threshold relative to best corner (goodFeaturesToTrack semantics)
    score = jnp.where(score >= quality_level * jnp.max(score), score, 0.0)

    # window NMS: keep local maxima of a (2r+1)^2 neighbourhood.  OpenCV's
    # greedy NMS keeps corners >= min_distance apart but retains the denser
    # of two nearby peaks; radius min_distance/2 reproduces its density.
    # Formulated as a separable shifted-max (2x(2r) jnp.maximum over padded
    # slices) rather than lax.reduce_window: the shifted maxima fuse into
    # the same elementwise pipeline as the score.  Scores are
    # >= 0 here (edge + quality gates above zero everything else), so 0.0
    # is a neutral pad value.
    r = max(1, int(min_distance) // 2)
    local_max = _window_max2d(score, r)
    is_peak = (score == local_max) & (score > 0.0)
    masked = jnp.where(is_peak, score, 0.0)

    flat = masked.reshape(-1)
    top_scores, top_idx = jax.lax.top_k(flat, num_features)
    uv = jnp.stack(
        [(top_idx % W).astype(jnp.float32), (top_idx // W).astype(jnp.float32)],
        axis=-1,
    )
    valid = top_scores > 0.0
    return uv, valid, top_scores
