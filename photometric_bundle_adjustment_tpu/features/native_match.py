"""ctypes loader for the native C++ Hamming matcher (the CPU fast path).

Same contract as ``features.match.match_descriptors`` vmapped over pairs:
given stacked packed descriptors + validity masks and a pair worklist,
returns (P, F) int32 match vectors (-1 = no match).  Compiled on demand
from native/hamming_matcher.cpp with ``g++ -O3 -march=native``; callers
should fall back to the XLA path when unavailable
(``tests/test_features.py`` asserts bit-exact agreement).

Ratio-test precision note: the reference compares ``second >= ratio * best``
in double (keypoints.h:251); this matcher does the same.  The XLA path
evaluates it in float32, so match sets can differ
on exact-boundary cases (e.g. ratio 1.2, best 60, second 72: 1.2 is not
representable in binary — f64 accepts, f32 rejects).  With ratios exactly
representable in float32 (1.25, 1.5) the two paths agree bit-for-bit.
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
        os.path.dirname(os.path.dirname(__file__)), "native",
        "hamming_matcher.cpp",
    )
    cache = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".native_cache",
    )
    os.makedirs(cache, exist_ok=True)
    lib_path = os.path.join(cache, "hamming_matcher.so")
    try:
        if (not os.path.exists(lib_path)) or (
            os.path.getmtime(lib_path) < os.path.getmtime(src)
        ):
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", lib_path, src],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(lib_path)
        lib.match_pairs_hamming.argtypes = [
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.match_pairs_hamming.restype = None
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


def available() -> bool:
    return _get_lib() is not None


def match_pairs(
    desc: np.ndarray,    # (I, F, 8) uint32 packed descriptors
    valid: np.ndarray,   # (I, F) bool
    pa: np.ndarray,      # (P,) int
    pb: np.ndarray,      # (P,) int
    threshold: int = 70,
    ratio: float = 1.2,
    n_threads: int = 0,
) -> np.ndarray:
    """Returns (P, F) int32: per left-feature match index into image pb's
    features, or -1 (matchDescriptors semantics, keypoints.h:259-278)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native hamming matcher unavailable")
    desc = np.ascontiguousarray(desc, np.uint32)
    I, F, W = desc.shape
    assert W == 8, "expected packed 256-bit descriptors (8 x uint32)"
    desc64 = np.ascontiguousarray(desc).view(np.uint64).reshape(I, F, 4)
    valid8 = np.ascontiguousarray(valid.astype(np.uint8))
    pa = np.ascontiguousarray(pa, np.int32)
    pb = np.ascontiguousarray(pb, np.int32)
    P = pa.shape[0]
    out = np.empty((P, F), np.int32)
    lib.match_pairs_hamming(
        P, F, np.ascontiguousarray(desc64.reshape(-1)), valid8.reshape(-1),
        pa, pb, int(threshold), float(ratio), int(n_threads),
        out.reshape(-1),
    )
    return out
