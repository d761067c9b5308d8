"""Roofline accounting for the hot kernels.

XLA's post-optimization ``cost_analysis`` on the compiled executable
supplies a FLOP and a byte count per call (model-level flops; logical
bytes accessed across fused ops); dividing by the measured steady-state
seconds per call yields achieved TFLOP/s and GB/s, which are compared with
the device's published peaks.

The peaks are one table keyed by ``jax.Device.device_kind``; a device that
is not in the table is an error, not a default.  The program pins float32
matrix products to full precision (utils/runtime.configure_runtime), so
its compute share is stated against the float32 peak outside the tensor
cores; the bf16 tensor-core share is reported beside it.  The "bound"
label names the resource with the higher utilisation — the one that must
improve for the kernel to go faster.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the full 700 W
# power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tensor_core_flops": 989e12,
        "tf32_tensor_core_flops": 495e12,
        "f32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks_for(device_kind: str) -> dict:
    """Published peaks of ``device_kind``; raises on an unknown device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak table for device kind {device_kind!r}; "
            f"known: {sorted(PEAKS)}"
        ) from None


def xla_cost(compiled) -> dict:
    """(flops, bytes) from a compiled executable's cost analysis."""
    ca = compiled.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    return {"flops": float(ca.get("flops", 0.0)),
            "bytes": float(ca.get("bytes accessed", 0.0))}


def jit_cost(fn, *args, **kwargs) -> dict:
    """Cost of one call of ``fn(*args)`` (compiles via the persistent
    cache; returns {'flops', 'bytes'})."""
    import jax

    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return xla_cost(jitted.lower(*args, **kwargs).compile())


def roofline(dt_seconds: float, flops: float, bytes_: float,
             device_kind: str) -> dict:
    """Achieved rates + fraction of the device's peaks + binding resource.

    ``bytes_`` comes from XLA's cost model, which counts each op's
    LOGICAL operand bytes before fusion — an upper bound on physical
    device-memory traffic.  A logical-bytes rate above the memory peak
    therefore means fusion keeps most of that traffic on chip (shared
    memory/registers), and the kernel is latency/issue-bound rather than
    memory-bound; the ``bound`` label says so explicitly instead of
    reporting an impossible >100% memory utilisation.
    """
    peaks = peaks_for(device_kind)
    tflops = flops / dt_seconds / 1e12
    gbps = bytes_ / dt_seconds / 1e9
    f32 = flops / dt_seconds / peaks["f32_flops"]
    tc = flops / dt_seconds / peaks["bf16_tensor_core_flops"]
    hbm = bytes_ / dt_seconds / peaks["hbm_bytes_per_s"]
    if hbm > 1.0:
        bound = "on-chip (fused); latency/issue"
    elif f32 < 0.02 and hbm < 0.02:
        bound = "latency/overhead"
    else:
        bound = "f32 compute" if f32 >= hbm else "hbm"
    return {
        "tflops": round(tflops, 2),
        "logical_gbps": round(gbps, 1),
        "pct_f32_peak": round(100 * f32, 1),
        "pct_tensor_core_bf16_peak": round(100 * tc, 1),
        "pct_hbm_peak_logical": round(100 * hbm, 1),
        "bound": bound,
    }
