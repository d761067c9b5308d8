"""Batched image-pair matching: descriptor matching + relative-pose RANSAC
for chunks of image pairs in one compiled computation.

This is the batched replacement for the reference's hottest stage — the TBB
``parallel_for`` over ~19,900 image pairs (sfm.cpp:1294-1319): pairs are
processed in fixed-size chunks, vmapped so every pair's (N1 x N2) Hamming
matrix, ratio/cross-check, and 128-hypothesis essential RANSAC fuse into
one XLA program.  With a device mesh, the chunk axis is sharded
data-parallel (each chip matches its slice of pairs; descriptors are small
enough to replicate — a ring pass over descriptor blocks only pays once
image counts reach thousands).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from photometric_bundle_adjustment_tpu.features import match, ransac
from photometric_bundle_adjustment_tpu.parallel.mesh import DATA_AXIS


def _pair_chunk_impl(desc, valid, bearings, i1, i2, key, *,
                     max_matches, match_max_dist, match_ratio,
                     ransac_thresh, ransac_min_inliers, ransac_hypotheses):
    """Traced body of one matching chunk.  The feature stacks ride as
    ARGUMENTS, not closure captures: captured jnp arrays become HLO
    constants, which bloats the program (~4 MB of literals at EuRoC
    scale), defeats the persistent compilation cache's cheap reload path,
    and re-ships the constants on every compile request (measured: a
    cached closure-constant program still costs ~4x a cached
    argument-passing one to first-call in a fresh process)."""
    MM = max_matches

    def one(a, b, k):
        m12 = match.match_descriptors(
            desc[a], desc[b], valid[a], valid[b], match_max_dist, match_ratio
        )
        pairs, pvalid, count = match.matches_to_pairs(m12, MM)
        b0 = bearings[a][pairs[:, 0]]
        b1 = bearings[b][pairs[:, 1]]
        T, inl, n_inl = ransac.ransac_relative_pose(
            b0, b1, pvalid, k,
            threshold=ransac_thresh,
            min_inliers=ransac_min_inliers,
            num_hypotheses=ransac_hypotheses,
        )
        enough = count > ransac_min_inliers
        inl = inl & enough
        return pairs, pvalid, count, T, inl, jnp.where(enough, n_inl, 0)

    keys = jax.random.split(key, i1.shape[0])
    return jax.vmap(one)(i1, i2, keys)


def make_pair_matcher(
    desc: jax.Array,       # (I, F, 8) uint32
    valid: jax.Array,      # (I, F) bool
    bearings: jax.Array,   # (I, F, 3)
    max_matches: int,
    match_max_dist: int,
    match_ratio: float,
    ransac_thresh: float,
    ransac_min_inliers: int,
    ransac_hypotheses: int,
    mesh: Mesh | None = None,
):
    """Returns chunk_fn(i1 (C,), i2 (C,), key) -> per-pair results.

    Outputs: (pairs (C, MM, 2), pair_valid (C, MM), count (C,), T (C, 7),
    inlier_mask (C, MM), n_inliers (C,)).  With a mesh, inputs/outputs are
    sharded over the chunk axis.
    """
    import functools

    impl = functools.partial(
        _pair_chunk_impl,
        max_matches=max_matches, match_max_dist=match_max_dist,
        match_ratio=match_ratio, ransac_thresh=ransac_thresh,
        ransac_min_inliers=ransac_min_inliers,
        ransac_hypotheses=ransac_hypotheses,
    )
    desc = jnp.asarray(desc)
    valid = jnp.asarray(valid)
    bearings = jnp.asarray(bearings)

    if mesh is None:
        jimpl = jax.jit(impl)

        def chunk(i1, i2, key):
            return jimpl(desc, valid, bearings, i1, i2, key)

        return chunk

    data = NamedSharding(mesh, P(DATA_AXIS))
    rep = NamedSharding(mesh, P())
    jimpl = jax.jit(
        impl,
        in_shardings=(rep, rep, rep, data, data, rep),
        out_shardings=(data, data, data, data, data, data),
    )

    def chunk(i1, i2, key):
        return jimpl(desc, valid, bearings, i1, i2, key)

    return chunk


def make_mega_pair_matcher(
    desc: jax.Array,
    valid: jax.Array,
    bearings: jax.Array,
    max_matches: int,
    match_max_dist: int,
    match_ratio: float,
    ransac_thresh: float,
    ransac_min_inliers: int,
    ransac_hypotheses: int,
):
    """Multi-chunk mega-dispatch matcher: ``mega(i1g, i2g, keys)`` runs G
    chunks (a ``lax.map`` over the per-chunk vmapped matcher) in ONE device
    dispatch and returns every per-pair result with a leading G axis.

    Purpose: dispatch-count reduction.  The 164-image EuRoC all-pairs stage
    is 416 chunks; dispatched one-by-one, each pays a host round trip.
    Folding chunks into a handful of fixed-G
    mega-dispatches removes the per-dispatch round trips without changing
    any per-pair result: the same chunk function runs under ``lax.map``
    with the same per-chunk keys, so outputs are bit-identical to the
    chunk-at-a-time path.  Ref: the TBB parallel_for being replaced,
    /root/reference/src/sfm.cpp:1294-1319.
    """
    import functools

    impl = functools.partial(
        _pair_chunk_impl,
        max_matches=max_matches, match_max_dist=match_max_dist,
        match_ratio=match_ratio, ransac_thresh=ransac_thresh,
        ransac_min_inliers=ransac_min_inliers,
        ransac_hypotheses=ransac_hypotheses,
    )
    desc = jnp.asarray(desc)
    valid = jnp.asarray(valid)
    bearings = jnp.asarray(bearings)

    @jax.jit
    def mega_impl(desc, valid, bearings, i1g, i2g, keys):
        def one_chunk(t):
            pairs, pvalid, count, T, inl, n_inl = impl(
                desc, valid, bearings, *t
            )
            # only what the host consumer reads, and pairs as int16
            # (feature ids < 2^15): the fetch is ~55 MB of the full-run
            # wall otherwise (pvalid/n_inl are derivable host-side)
            return pairs.astype(jnp.int16), count, T, inl

        return jax.lax.map(one_chunk, (i1g, i2g, keys))

    def mega(i1g, i2g, keys):  # (G, C) x2 + (G,) chunk keys
        return mega_impl(desc, valid, bearings, i1g, i2g, keys)

    return mega


def make_ransac_chunk(
    bearings: jax.Array,   # (I, F, 3)
    ransac_thresh: float,
    ransac_min_inliers: int,
    ransac_hypotheses: int,
):
    """RANSAC-only chunk function for pre-computed matches (the native C++
    Hamming matcher supplies the match lists on CPU; see
    features/native_match.py).  chunk(i1, i2, pairs (C, MM, 2),
    pvalid (C, MM), count (C,), key) -> (T, inlier_mask, n_inliers)."""

    def one(a, b, pairs, pvalid, count, k):
        b0 = bearings[a][pairs[:, 0]]
        b1 = bearings[b][pairs[:, 1]]
        T, inl, n_inl = ransac.ransac_relative_pose(
            b0, b1, pvalid, k,
            threshold=ransac_thresh,
            min_inliers=ransac_min_inliers,
            num_hypotheses=ransac_hypotheses,
        )
        enough = count > ransac_min_inliers
        inl = inl & enough
        return T, inl, jnp.where(enough, n_inl, 0)

    def chunk(i1, i2, pairs, pvalid, count, key):
        keys = jax.random.split(key, i1.shape[0])
        return jax.vmap(one)(i1, i2, pairs, pvalid, count, keys)

    return jax.jit(chunk)


def ring_match_all_pairs(
    desc: jax.Array,     # (I, F, 8) uint32, I divisible by mesh size
    valid: jax.Array,    # (I, F) bool
    mesh: Mesh,
    *,
    max_matches: int,
    threshold: int = 70,
    ratio: float = 1.2,
):
    """All-pairs descriptor matching with ring-passed descriptor blocks.

    The memory-scaling formulation of the reference's all-pairs stage
    (sfm.cpp:1284-1319): descriptors are SHARDED over images (each device
    holds I/D of them — nothing is replicated), and a traveling copy of
    each block rotates around the ring via ``ppermute``; at step s device d
    matches its resident block against the block that started on device
    (d - s) mod D.  After D steps every (resident, traveling) image pair
    has been matched on exactly one device — structurally identical to
    ring attention over the image axis (SURVEY §5: the "long axis" of this
    workload), with per-step interconnect traffic of one descriptor block instead
    of an all-gather of all of them.

    Returns (pairs (I, I, MM, 2) int32, pvalid (I, I, MM) bool,
    count (I, I) int32), sharded over the first (resident-image) axis;
    row a, column b holds matchDescriptors(a, b) semantics including the
    mutual cross-check (keypoints.h:259-278).  The diagonal is the
    self-match and should be ignored by callers.
    """
    from jax import shard_map

    I, F, Wn = desc.shape
    D = mesh.shape[DATA_AXIS]
    if I % D != 0:
        raise ValueError(f"image count {I} not divisible by mesh size {D}")
    B = I // D
    MM = max_matches

    def shard_fn(desc_l, valid_l):
        d = jax.lax.axis_index(DATA_AXIS)

        def match_block(trav_desc, trav_valid):
            def one(da, va):
                def two(db, vb):
                    m12 = match.match_descriptors(
                        da, db, va, vb, threshold, ratio
                    )
                    p, v, c = match.matches_to_pairs(m12, MM)
                    return p, v, jnp.asarray(c, jnp.int32)

                return jax.vmap(two)(trav_desc, trav_valid)

            return jax.vmap(one)(desc_l, valid_l)

        perm = [(i, (i + 1) % D) for i in range(D)]

        def step(s, carry):
            trav_desc, trav_valid, pairs, pvalid, count = carry
            src = jax.lax.rem(
                d - jnp.asarray(s, jnp.int32) + jnp.int32(D), jnp.int32(D)
            )
            p, v, c = match_block(trav_desc, trav_valid)
            z = jnp.int32(0)
            col = src * jnp.int32(B)
            pairs = jax.lax.dynamic_update_slice(pairs, p, (z, col, z, z))
            pvalid = jax.lax.dynamic_update_slice(pvalid, v, (z, col, z))
            count = jax.lax.dynamic_update_slice(count, c, (z, col))
            trav_desc = jax.lax.ppermute(trav_desc, DATA_AXIS, perm)
            trav_valid = jax.lax.ppermute(trav_valid, DATA_AXIS, perm)
            return trav_desc, trav_valid, pairs, pvalid, count

        def vary(x):  # mark the zero-filled accumulators device-varying
            return jax.lax.pcast(x, (DATA_AXIS,), to="varying")

        carry = (
            desc_l,
            valid_l,
            vary(jnp.zeros((B, I, MM, 2), jnp.int32)),
            vary(jnp.zeros((B, I, MM), bool)),
            vary(jnp.zeros((B, I), jnp.int32)),
        )
        carry = jax.lax.fori_loop(0, D, step, carry)
        return carry[2], carry[3], carry[4]

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
        out_specs=(
            P(DATA_AXIS, None, None, None),
            P(DATA_AXIS, None, None),
            P(DATA_AXIS, None),
        ),
    )
    return jax.jit(fn)(desc, valid)


def compact_matches_np(m12_all, max_matches: int):
    """Vectorised numpy analog of match.matches_to_pairs over a (P, F)
    match table: returns (pairs (P, MM, 2) int32, pvalid (P, MM) bool,
    count (P,) int32)."""
    import numpy as np

    P, F = m12_all.shape
    ism = m12_all >= 0
    order = np.argsort(~ism, axis=1, kind="stable")
    rows = order[:, :max_matches].astype(np.int32)
    cols = m12_all[np.arange(P)[:, None], rows].astype(np.int32)
    count = np.minimum(ism.sum(1), max_matches).astype(np.int32)
    k = np.arange(max_matches, dtype=np.int32)
    pvalid = k[None, :] < count[:, None]
    pairs = np.stack(
        [np.where(pvalid, rows, 0), np.where(pvalid, cols, 0)], axis=-1
    )
    return pairs, pvalid, count
