"""Host-precomputed index plans for fused Schur normal-equation assembly.

The reference delegates sparse normal-equation assembly + Schur elimination
to Ceres' SPARSE_SCHUR backend (include/visnav/map_utils.h:377-383), which
builds block-sparse structures from per-residual parameter-block pointers at
solve time.  On an accelerator, data-dependent scatter-adds are the
bottleneck of that formulation.  This module replaces them with
*host-precomputed
gather plans*: because the observation graph is fixed for the duration of a
solve, every sparse reduction can be phrased as

    gather payload rows by a precomputed index matrix -> dense partial sums
    over chunks -> one tiny scatter over the number of CHUNKS (thousands)
    instead of observations (hundreds of thousands).

Plans are plain arrays (a pytree), passed to the jitted solver as arguments;
their shapes are bucketed (rounded up) so growing problems re-use compiled
code.

Three plan families:

  * camera-pair chunks: observations sorted by (anchor, target) camera pair;
    each chunk's Gram matrix gives all four camera-camera Hessian blocks as
    one small batched matmul (a matmul does the reduction, not a scatter),
  * landmark / camera chunks: generic chunked segment sums for the scalar
    landmark blocks, gradients, and anchor-merged couplings,
  * one-hot camera lifting for the Schur correction: the per-landmark
    camera-coupling rows  M[l] = c_l^T  (the landmark's column of H_cp,
    flattened to K*C) are assembled densely by a one-hot einsum over the
    landmark chunks plus an anchor outer product, and the correction
    S -= sum_l c_l c_l^T / hpp_l  becomes ONE (K*C, L) x (L, K*C)
    matmul — a trade of dense FLOPs for irregular gathers.  The lambda
    dependence stays analytic:
    S_corr(lam) = S_corr(0) / (1 + lam).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ChunkPlan(NamedTuple):
    """Chunked segment-sum: payload rows gathered by ``gidx`` are summed per
    chunk and scatter-added at ``rows``.  Dummy gathers point at the payload's
    trailing zero row; dummy chunks scatter into a dropped trailing row."""

    gidx: np.ndarray  # (NC, B) int32 into payload rows [0, N]; N = zero row
    rows: np.ndarray  # (NC,) int32 into output rows [0, R]; R = dropped row


class SchurPlan(NamedTuple):
    """Full assembly plan for one BA problem's observation graph."""

    # camera-pair Gram chunks for H_cc
    pg: np.ndarray        # (NCp, Bp) int32 obs ids [0, O]; O = zero Js row
    cc_rows4: np.ndarray  # (NCp, 4) int32 rows into (K*K [+1 dropped], .)
    # landmark segment sums (anchor merge, H_pp, g_p, back-substitution)
    lm: ChunkPlan         # payload rows: obs ids [0, O] -> L rows
    # camera segment sums for g_c (anchor rows / target rows separately,
    # both over obs ids [0, O] — avoids a (2O, C) payload concatenate)
    gc_a: ChunkPlan       # payload rows: obs ids [0, O] -> K
    gc_t: ChunkPlan       # payload rows: obs ids [0, O] -> K
    # one-hot camera lifting for the dense Schur-correction matrix M (L, K*C)
    lm_cam: np.ndarray           # (NC_lm, B_lm) int32 target cam of each obs
    #                              gathered by lm.gidx; K for dummy slots
    #                              (one_hot(K, K) == 0 masks them out)
    anchor_cam_of_lm: np.ndarray  # (L,) int32 anchor camera per landmark;
    #                               K for landmarks with no valid obs


class DenseLmSchurPlan(NamedTuple):
    """Assembly plan for the SLOT-MAJOR landmark-dense observation layout.

    The problem's observation rows are host-reordered into (S, L) slots —
    row ``s*L + l`` is the s-th observation of landmark l (padding slots
    have valid=0) — so every landmark-axis reduction in the fused solver
    (anchor couplings, H_pp, g_p, and the rows of the dense Schur matrix M)
    becomes a RESHAPE to (S, L, width) + a dense sum over the leading slot
    axis.  Slot-major matters in tiled layouts: the reshape keeps the
    (L, width) minor dims, whose tile padding is benign, whereas the
    landmark-major (L, S, width) view puts the tiny (S, width) dims in the
    tile and inflates every read.  The per-camera gradient g_c is
    assembled by two one-hot (K, O)x(O, C) matmuls instead of chunked
    segment sums — same dense-FLOPs-for-irregular-gathers trade as the
    Schur-correction lift.  Camera-pair (H_cc) reductions keep their Gram
    chunks, built over the reordered rows.
    """

    pg: np.ndarray        # (NCp, Bp) int32 into padded obs rows [0, L*S]
    cc_rows4: np.ndarray  # (NCp, 4) int32 rows into (K*K [+1 dropped], .)
    obs_anchor_cam: np.ndarray  # (L*S,) int32 anchor cam per row; K if pad
    obs_target_cam: np.ndarray  # (L*S,) int32 target cam per row; K if pad
    lm_cam: np.ndarray    # (S, L) int32 target cam per slot; K for padding
    anchor_cam_of_lm: np.ndarray  # (L,) int32; K for landmarks with no obs


def _round_up(n: int, minimum: int, pow2: bool = True) -> int:
    """Round a chunk count up to a bucketed static shape.

    pow2=True (default): next power of two >= minimum.  Chunk counts change
    with every map update; power-of-two bucketing keeps the jitted solver's
    shapes repeating (a handful of compiles per run instead of one per BA
    call).

    pow2=False: next multiple of ``minimum`` — tighter padding for problems
    whose observation graph is fixed (benchmarks, one-shot solves), where
    the ~1.3-1.7x pow2 padding would cost real throughput."""
    if not pow2:
        return ((n + minimum - 1) // minimum) * minimum if n > 0 else minimum
    b = max(1, minimum)
    while b < n:
        b *= 2
    return b


def _chunk_segments(ids: np.ndarray, B: int):
    """Split a sorted-id contribution list into chunks of <= B entries that
    each touch exactly one output row.  Returns (gather_order (NC, B) with -1
    padding, row_ids (NC,)) — vectorised, no per-element Python loops."""
    N = ids.shape[0]
    if N == 0:
        return np.zeros((0, B), np.int64) - 1, np.zeros((0,), np.int64)
    order = np.argsort(ids, kind="stable")
    sids = ids[order]
    new_seg = np.r_[True, sids[1:] != sids[:-1]]
    seg_id = np.cumsum(new_seg) - 1                     # (N,)
    seg_start = np.flatnonzero(new_seg)                 # (S,)
    pos_in_seg = np.arange(N) - seg_start[seg_id]
    chunk_in_seg = pos_in_seg // B
    slot = pos_in_seg - chunk_in_seg * B
    chunks_per_seg = chunk_in_seg[np.r_[seg_start[1:] - 1, N - 1]] + 1  # (S,)
    chunk_offset = np.r_[0, np.cumsum(chunks_per_seg)[:-1]]
    chunk_id = chunk_offset[seg_id] + chunk_in_seg
    NC = int(chunk_offset[-1] + chunks_per_seg[-1])
    gidx = np.full((NC, B), -1, np.int64)
    gidx[chunk_id, slot] = order
    rows = np.empty(NC, np.int64)
    rows[chunk_id] = sids
    return gidx, rows


def _build_chunk_plan(ids, B, dummy_payload, dummy_row, nc_bucket=256,
                      pow2=True):
    gidx, rows = _chunk_segments(np.asarray(ids), B)
    NC = gidx.shape[0]
    NCb = _round_up(NC, nc_bucket, pow2)
    g = np.full((NCb, B), dummy_payload, np.int64)
    g[:NC] = np.where(gidx >= 0, gidx, dummy_payload)
    r = np.full(NCb, dummy_row, np.int64)
    r[:NC] = rows
    return ChunkPlan(g.astype(np.int32), r.astype(np.int32))


def build_schur_plan(
    anchor_cam,
    target_cam,
    landmark,
    K: int,
    L: int,
    valid=None,
    *,
    pair_chunk: int = 32,
    lm_chunk: int = 8,
    cam_chunk: int = 256,
    nc_bucket: int = 64,
    pow2_buckets: bool = True,
) -> SchurPlan:
    """Build the assembly plan on the host from the observation graph.

    Invalid (padding) observations are excluded from every plan — their
    payload is zero anyway, and excluding them keeps dummy gather slots
    pointed at the payload's zero row.
    """
    an = np.asarray(anchor_cam, np.int64)
    tn = np.asarray(target_cam, np.int64)
    ln = np.asarray(landmark, np.int64)
    O = an.shape[0]
    if valid is None:
        vmask = np.ones(O, bool)
    else:
        vmask = np.asarray(valid).astype(bool)
    vidx = np.flatnonzero(vmask)

    # ---- camera-pair Gram chunks for H_cc --------------------------------
    pair_ids = an[vidx] * K + tn[vidx]
    gidx, prows = _chunk_segments(pair_ids, pair_chunk)
    # map chunk-local gather slots back to original obs ids
    gidx = np.where(gidx >= 0, vidx[np.clip(gidx, 0, None)], O)
    NCp = gidx.shape[0]
    NCpb = _round_up(NCp, nc_bucket, pow2_buckets)
    pg = np.full((NCpb, pair_chunk), O, np.int64)
    pg[:NCp] = gidx
    pa, pc = prows // K, prows % K
    rows4 = np.stack([pa * K + pa, pa * K + pc, pc * K + pa, pc * K + pc], 1)
    cc_rows4 = np.full((NCpb, 4), K * K, np.int64)
    cc_rows4[:NCp] = rows4

    # ---- landmark chunks (payload = obs rows, valid only) -----------------
    g2, r2 = _chunk_segments(ln[vidx], lm_chunk)
    g2 = np.where(g2 >= 0, vidx[np.clip(g2, 0, None)], O)
    NC2 = g2.shape[0]
    NC2b = _round_up(NC2, nc_bucket, pow2_buckets)
    lg = np.full((NC2b, lm_chunk), O, np.int64)
    lg[:NC2] = g2
    lr = np.full(NC2b, L, np.int64)
    lr[:NC2] = r2
    lm_plan = ChunkPlan(lg.astype(np.int32), lr.astype(np.int32))

    # ---- camera chunks for g_c: anchor rows and target rows separately ---
    def cam_chunk_plan(cam_ids):
        g3, r3 = _chunk_segments(cam_ids, cam_chunk)
        g3 = np.where(g3 >= 0, vidx[np.clip(g3, 0, None)], O)
        NC3 = g3.shape[0]
        NC3b = _round_up(NC3, nc_bucket, pow2_buckets)
        gg = np.full((NC3b, cam_chunk), O, np.int64)
        gg[:NC3] = g3
        gr = np.full(NC3b, K, np.int64)
        gr[:NC3] = r3
        return ChunkPlan(gg.astype(np.int32), gr.astype(np.int32))

    gc_a_plan = cam_chunk_plan(an[vidx])
    gc_t_plan = cam_chunk_plan(tn[vidx])

    # ---- one-hot camera lifting tables for the dense M (L, K*C) ----------
    # target camera of each obs gathered by lm.gidx; dummy slots -> K
    lm_cam = np.where(lm_plan.gidx < O, tn[np.clip(lm_plan.gidx, 0, O - 1)], K)
    # first valid obs of each landmark defines its anchor camera; K if none
    anchor_cam_of_lm = np.full(L, K, np.int64)
    order = np.argsort(ln[vidx], kind="stable")
    lv = ln[vidx][order]
    firsts = np.flatnonzero(np.r_[True, lv[1:] != lv[:-1]])
    anchor_cam_of_lm[lv[firsts]] = an[vidx][order][firsts]

    return SchurPlan(
        pg=pg.astype(np.int32),
        cc_rows4=cc_rows4.astype(np.int32),
        lm=lm_plan,
        gc_a=gc_a_plan,
        gc_t=gc_t_plan,
        lm_cam=lm_cam.astype(np.int32),
        anchor_cam_of_lm=anchor_cam_of_lm.astype(np.int32),
    )


def build_dense_lm_plan(
    anchor_cam,
    target_cam,
    landmark,
    K: int,
    L: int,
    valid=None,
    *,
    pair_chunk: int = 32,
    cam_chunk: int = 256,
    nc_bucket: int = 64,
    pow2_buckets: bool = True,
    slot_bucket: int = 2,
    slots: int | None = None,
):
    """Slot-major landmark-dense layout: returns ``(perm, plan)``.

    ``perm`` is an (S*L,) int64 map from padded rows to original
    observation rows (-1 for padding slots); padded row ``s*L + l`` is the
    s-th observation of landmark l.  The caller reorders the problem's
    observation arrays with it (see ``fused.densify_problem``).
    S is the max valid-observation count of any landmark, rounded up to a
    multiple of ``slot_bucket`` (pow2-bucketed if ``pow2_buckets`` so that
    growing problems reuse compiled code).
    """
    an = np.asarray(anchor_cam, np.int64)
    tn = np.asarray(target_cam, np.int64)
    ln = np.asarray(landmark, np.int64)
    O = an.shape[0]
    vmask = np.ones(O, bool) if valid is None else np.asarray(valid).astype(bool)
    vidx = np.flatnonzero(vmask)

    counts = np.bincount(ln[vidx], minlength=L)
    S = _round_up(max(int(counts.max()) if vidx.size else 1, 1),
                  slot_bucket, pow2_buckets)
    if slots is not None:
        if slots < S and slots < int(counts.max() if vidx.size else 1):
            raise ValueError(
                f"forced slots={slots} < max obs per landmark {counts.max()}"
            )
        S = max(slots, 1)

    # slot assignment: stable order within each landmark; slot-major rows
    order = np.argsort(ln[vidx], kind="stable")
    ov = vidx[order]
    lv = ln[vidx][order]
    starts = np.r_[0, np.cumsum(counts)[:-1]]
    slot = np.arange(ov.size) - starts[lv]
    perm = np.full(S * L, -1, np.int64)
    perm[slot * L + lv] = ov

    Opad = L * S
    filled = perm >= 0
    rows = np.flatnonzero(filled)
    an_d = an[np.where(filled, perm, 0)]
    tn_d = tn[np.where(filled, perm, 0)]

    # camera-pair Gram chunks over the padded rows
    pair_ids = an_d[rows] * K + tn_d[rows]
    gidx, prows = _chunk_segments(pair_ids, pair_chunk)
    gidx = np.where(gidx >= 0, rows[np.clip(gidx, 0, None)], Opad)
    NCp = gidx.shape[0]
    NCpb = _round_up(NCp, nc_bucket, pow2_buckets)
    pg = np.full((NCpb, pair_chunk), Opad, np.int64)
    pg[:NCp] = gidx
    pa, pc = prows // K, prows % K
    rows4 = np.stack([pa * K + pa, pa * K + pc, pc * K + pa, pc * K + pc], 1)
    cc_rows4 = np.full((NCpb, 4), K * K, np.int64)
    cc_rows4[:NCp] = rows4

    # per-row camera ids for the one-hot g_c matmuls (K masks padding rows)
    obs_anchor_cam = np.where(filled, an_d, K)
    obs_target_cam = np.where(filled, tn_d, K)

    lm_cam = np.where(filled, tn_d, K).reshape(S, L)
    anchor_cam_of_lm = np.full(L, K, np.int64)
    has = counts > 0
    anchor_cam_of_lm[has] = an_d.reshape(S, L)[0][has]

    plan = DenseLmSchurPlan(
        pg=pg.astype(np.int32),
        cc_rows4=cc_rows4.astype(np.int32),
        obs_anchor_cam=obs_anchor_cam.astype(np.int32),
        obs_target_cam=obs_target_cam.astype(np.int32),
        lm_cam=lm_cam.astype(np.int32),
        anchor_cam_of_lm=anchor_cam_of_lm.astype(np.int32),
    )
    return perm, plan
