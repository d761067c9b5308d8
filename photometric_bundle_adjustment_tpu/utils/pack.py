"""Pytree <-> per-dtype flat-buffer packing for low-latency dispatch.

Every jit argument is its own host->device transfer, each paying a fixed
per-transfer latency.  A BA solve's (problem, plan) pytree is ~20 arrays.
Packing the tree into ONE flat buffer per dtype turns a solve into 2-3
uploads; unpacking inside the jitted program is static slicing (free on
device).

The spec returned by :func:`pack_tree` is hashable (treedef + dtype/shape
tuples) so it can ride a jit call as a static argument.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_tree(tree):
    """Flatten ``tree`` (numpy/jax leaves) into per-dtype 1-D numpy
    buffers.

    Returns ``(buffers: dict[str, np.ndarray], spec)`` where ``spec`` is a
    hashable description: ``(treedef, leaves)`` with ``leaves`` a tuple of
    ``(dtype_name, shape)`` in flatten order.  Use with
    :func:`unpack_tree` inside jit.
    """
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    order: dict = {}
    parts: dict = {}
    desc = []
    for leaf in leaves:
        a = np.asarray(leaf)
        key = a.dtype.name
        desc.append((key, a.shape))
        parts.setdefault(key, []).append(a.ravel())
        order[key] = True
    buffers = {k: (np.concatenate(v) if v else np.zeros(0))
               for k, v in parts.items()}
    return buffers, (treedef, tuple(desc))


def pack_tree_bytes(tree, x64: bool | None = None):
    """Flatten ``tree`` into ONE 1-D uint8 numpy buffer.

    The per-dtype packing above still leaves one upload per dtype
    (EuRoC BA solve: f32 + f64 + i32 + u8 ≈ 4 buffers).  Packing to raw
    bytes makes a solve exactly TWO transfers: one upload, one fetched
    result.  Leaves
    are canonicalized host-side first (f64->f32, i64->i32 unless
    ``x64``, matching what jnp.asarray would have done on device — this
    also HALVES the uv payload bytes that previously rode as f64), then
    viewed as bytes at itemsize-aligned offsets.  Device-side recovery
    (:func:`unpack_tree_bytes`) is static slices + bitcast-converts —
    no data movement, verified bit-exact vs the numpy views.

    Returns ``(buf: np.ndarray uint8 1-D, spec)``, spec hashable.
    """
    if x64 is None:
        x64 = bool(jax.config.jax_enable_x64)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    desc = []
    chunks = []
    off = 0
    for leaf in leaves:
        a = np.asarray(leaf)
        if not x64:
            if a.dtype == np.float64:
                a = a.astype(np.float32)
            elif a.dtype == np.int64:
                a = a.astype(np.int32)
            elif a.dtype == np.uint64:
                a = a.astype(np.uint32)
        is_bool = a.dtype == np.bool_
        raw = np.ascontiguousarray(a).ravel().view(np.uint8)
        pad = (-off) % max(a.dtype.itemsize, 1)
        if pad:
            chunks.append(np.zeros(pad, np.uint8))
            off += pad
        desc.append((a.dtype.name, a.shape, off, is_bool))
        chunks.append(raw)
        off += raw.size
    buf = (np.concatenate(chunks) if chunks
           else np.zeros(0, np.uint8))
    return buf, (treedef, tuple(desc))


def unpack_tree_bytes(buf, spec):
    """Inverse of :func:`pack_tree_bytes` for use INSIDE jit: static
    byte slices + ``lax.bitcast_convert_type`` per leaf (bools ride as
    uint8 and are recovered with ``!= 0``)."""
    treedef, desc = spec
    leaves = []
    for dtype_name, shape, off, is_bool in desc:
        dt = np.dtype(dtype_name)
        n = int(np.prod(shape)) if shape else 1
        seg = jax.lax.slice(buf, (off,), (off + n * dt.itemsize,))
        if is_bool:
            leaf = (seg != 0).reshape(shape)
        elif dt.itemsize == 1:
            leaf = jax.lax.bitcast_convert_type(
                seg, jnp.dtype(dt)
            ).reshape(shape)
        else:
            leaf = jax.lax.bitcast_convert_type(
                seg.reshape(n, dt.itemsize), jnp.dtype(dt)
            ).reshape(shape)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def unpack_tree(buffers, spec):
    """Inverse of :func:`pack_tree` for use INSIDE a jitted function:
    ``buffers`` is a dict of 1-D arrays (device), ``spec`` the static
    description; returns the original pytree of device arrays (static
    slices + reshapes — no data movement)."""
    treedef, desc = spec
    offsets = {k: 0 for k in buffers}
    leaves = []
    for key, shape in desc:
        n = int(np.prod(shape)) if shape else 1
        off = offsets[key]
        leaves.append(buffers[key][off: off + n].reshape(shape))
        offsets[key] = off + n
    return jax.tree_util.tree_unflatten(treedef, leaves)
