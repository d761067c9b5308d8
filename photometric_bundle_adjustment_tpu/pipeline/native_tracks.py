"""Vectorised + native track building.

Fast path for ``pipeline.tracks.build_tracks``: node enumeration and track
filtering are vectorised numpy; the union-find core runs in the C++ shared
library (native/trackbuilder.cpp), compiled on demand with g++ and loaded
via ctypes.  Falls back to the pure-Python implementation when no compiler
is available.  Semantics are identical (same filter rules as
tracks.h:103-146); ``test_pipeline.py`` asserts agreement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_LIB_FAILED = False


def _get_lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    src = os.path.join(
        os.path.dirname(os.path.dirname(__file__)), "native", "trackbuilder.cpp"
    )
    cache = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".native_cache",
    )
    os.makedirs(cache, exist_ok=True)
    lib_path = os.path.join(cache, "trackbuilder.so")
    try:
        if (not os.path.exists(lib_path)) or (
            os.path.getmtime(lib_path) < os.path.getmtime(src)
        ):
            subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-o", lib_path, src],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(lib_path)
        lib.uf_build.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        lib.uf_build.restype = None
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


def build_tracks(matches: dict, min_track_length: int = 3) -> dict:
    """Drop-in replacement for tracks.build_tracks (same output dict)."""
    lib = _get_lib()
    if lib is None:
        from photometric_bundle_adjustment_tpu.pipeline import tracks

        return tracks.build_tracks(matches, min_track_length)

    # encode nodes as (fcid_code, feature) with fcid_code = frame * 2 + cam
    # (stereo rigs; generalises via the fcid table below)
    fcids = sorted({f for pair in matches for f in pair})
    fcid_code = {f: i for i, f in enumerate(fcids)}
    BIG = 1 << 22  # > max features per image

    a_list, b_list = [], []
    for (fi, fj), inliers in matches.items():
        arr = np.asarray(inliers, np.int64).reshape(-1, 2)
        if len(arr) == 0:
            continue
        a_list.append(fcid_code[fi] * BIG + arr[:, 0])
        b_list.append(fcid_code[fj] * BIG + arr[:, 1])
    if not a_list:
        return {}
    a = np.concatenate(a_list)
    b = np.concatenate(b_list)

    nodes = np.unique(np.concatenate([a, b]))
    ai = np.searchsorted(nodes, a)
    bi = np.searchsorted(nodes, b)

    roots = np.empty(len(nodes), np.int64)
    lib.uf_build(len(nodes), len(a), np.ascontiguousarray(ai),
                 np.ascontiguousarray(bi), roots)

    # vectorised filtering: group sizes, distinct-image counts
    img_of_node = nodes // BIG
    feat_of_node = nodes % BIG
    order = np.argsort(roots, kind="stable")
    r_sorted = roots[order]
    group_start = np.flatnonzero(
        np.concatenate([[True], r_sorted[1:] != r_sorted[:-1]])
    )
    group_sizes = np.diff(np.concatenate([group_start, [len(r_sorted)]]))

    # distinct images per group: unique (root, image) pairs
    pair_codes = np.unique(roots.astype(np.uint64) * np.uint64(1 << 20)
                           + img_of_node.astype(np.uint64))
    uniq_roots_of_pairs = (pair_codes >> np.uint64(20)).astype(np.int64)
    distinct_imgs = np.bincount(
        np.searchsorted(r_sorted[group_start], uniq_roots_of_pairs),
        minlength=len(group_start),
    )

    keep = (group_sizes >= min_track_length) & (distinct_imgs == group_sizes)

    tracks_out: dict = {}
    keep_group_of_node = keep[
        np.searchsorted(r_sorted[group_start], roots)
    ]
    for idx in np.flatnonzero(keep_group_of_node):
        tid = int(roots[idx])
        tracks_out.setdefault(tid, {})[fcids[int(img_of_node[idx])]] = int(
            feat_of_node[idx]
        )
    return tracks_out
