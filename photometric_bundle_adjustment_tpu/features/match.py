"""Descriptor matching: Hamming distance + ratio test + mutual cross-check.

Semantics of the reference's matchSets/matchDescriptors
(keypoints.h:223-278): a left feature matches right feature j iff
  * j minimises the Hamming distance,
  * best distance < threshold (70 default, sfm.cpp:200),
  * second-best >= best * ratio (1.2 default, sfm.cpp:201-202),
  * and the right->left match agrees (mutual cross-check).

The distance matrix is plain XLA (vmappable over image pairs) in one of two
bit-identical forms, xor+popcount or an int8 matrix product.  Shapes are
static: descriptor arrays are padded with a validity mask and results use
-1 for "no match".
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BIG = jnp.int32(1 << 20)


def hamming_matrix(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """(N1, N2) int32 Hamming distances between packed (N, 8)-uint32 rows.

    On accelerators the distance runs as an int8 matrix product
    (:func:`hamming_matrix_mxu`), bit-identical to the xor+popcount form
    that the CPU runs."""
    if jax.default_backend() != "cpu":
        return hamming_matrix_mxu(d1, d2)
    return hamming_matrix_popcount(d1, d2)


def hamming_matrix_popcount(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """Hamming distances as xor + population count over the eight words."""
    acc = jnp.zeros((d1.shape[0], d2.shape[0]), jnp.int32)
    for w in range(8):
        x = jnp.bitwise_xor(d1[:, w][:, None], d2[:, w][None, :])
        acc = acc + jax.lax.population_count(x).astype(jnp.int32)
    return acc


def hamming_matrix_mxu(d1: jax.Array, d2: jax.Array) -> jax.Array:
    """Hamming distances as one int8 matrix product.

    The 256 descriptor bits are unpacked to {0,1} int8 bit-planes and

        H(a, b) = pop(a) + pop(b) - 2 a.b

    turns the distance matrix into ONE int8 matmul with exact int32
    accumulation — bit-identical to the xor+popcount formulation, with
    the O(N^2 * 256) work in the matrix units.  Ref: the std::bitset
    matcher being replaced, include/visnav/keypoints.h:223-278."""

    def bits(d):  # (N, 8) uint32 -> (N, 256) int8 bit-planes
        shifts = jnp.arange(32, dtype=jnp.uint32)
        b = (d[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
        return b.reshape(d.shape[0], 256).astype(jnp.int8)

    a = bits(d1)
    b = bits(d2)
    na = jnp.sum(a.astype(jnp.int32), axis=1)
    nb = jnp.sum(b.astype(jnp.int32), axis=1)
    ab = jax.lax.dot_general(
        a, b, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return na[:, None] + nb[None, :] - 2 * ab


def _best_two_from(dist, axis):
    """(best, second, best_idx) along ``axis`` of a masked distance
    matrix (invalid entries already BIG)."""
    best = jnp.min(dist, axis=axis)
    bidx = jnp.argmin(dist, axis=axis).astype(jnp.int32)
    idx = jax.lax.broadcasted_iota(jnp.int32, dist.shape, axis)
    hit = idx == jnp.expand_dims(bidx, axis)
    second = jnp.min(jnp.where(hit, BIG, dist), axis=axis)
    return best, second, bidx


def _one_way(best, second, bidx, valid1, threshold, ratio):
    """matchSets accept rule (keypoints.h:247-253)."""
    ok = (best < threshold) & (second.astype(jnp.float32) >= best.astype(jnp.float32) * ratio)
    ok = ok & valid1
    return jnp.where(ok, bidx, -1)


@jax.jit
def match_descriptors(
    d1: jax.Array,
    d2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    threshold: int = 70,
    ratio: float = 1.2,
):
    """Mutual best matches.  Returns (N1,) int32: index into d2 or -1.

    Matches matchDescriptors (keypoints.h:259-278).
    """
    # ONE Hamming matrix serves both directions (hamming(a, b) is
    # symmetric in the pair): the reverse pass reduces along axis 0
    # instead of recomputing the XOR/popcount matrix transposed.
    dist = hamming_matrix(d1, d2)
    b1, s1, i1 = _best_two_from(jnp.where(valid2[None, :], dist, BIG), 1)
    b2, s2, i2 = _best_two_from(jnp.where(valid1[:, None], dist, BIG), 0)

    m12 = _one_way(b1, s1, i1, valid1, threshold, ratio)  # (N1,)
    m21 = _one_way(b2, s2, i2, valid2, threshold, ratio)  # (N2,)

    # cross-check: m21[m12[i]] == i
    back = jnp.where(m12 >= 0, m21[jnp.clip(m12, 0, m21.shape[0] - 1)], -2)
    rows = jnp.arange(m12.shape[0], dtype=jnp.int32)
    return jnp.where((m12 >= 0) & (back == rows), m12, -1)


def matches_to_pairs(m12: jax.Array, max_matches: int):
    """Compact (N1,) match vector into fixed-size (max_matches, 2) index
    pairs + count (static shapes for downstream RANSAC)."""
    N1 = m12.shape[0]
    is_match = m12 >= 0
    order = jnp.argsort(~is_match, stable=True)  # matched rows first
    if N1 < max_matches:
        order = jnp.concatenate(
            [order, jnp.zeros(max_matches - N1, order.dtype)]
        )
    rows = order[:max_matches].astype(jnp.int32)
    cols = m12[rows]
    count = jnp.minimum(jnp.sum(is_match.astype(jnp.int32)), max_matches)
    k = jnp.arange(max_matches, dtype=jnp.int32)
    valid = k < count
    pairs = jnp.stack(
        [jnp.where(valid, rows, 0), jnp.where(valid, cols, 0)], axis=-1
    )
    return pairs, valid, count
