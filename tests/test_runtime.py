"""Runtime settings (compilation cache, matmul precision) and the roofline
peak table."""

import jax
import pytest

from photometric_bundle_adjustment_tpu.utils import roofline, runtime


def _record_config(monkeypatch):
    calls = {}
    monkeypatch.setattr(
        jax.config, "update", lambda name, value: calls.__setitem__(name, value)
    )
    return calls


def test_compile_cache_honours_env_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
    calls = _record_config(monkeypatch)
    assert runtime.configure_runtime() == str(tmp_path / "x")
    # JAX reads the variable itself; the directory is used as given
    assert "jax_compilation_cache_dir" not in calls
    assert calls["jax_default_matmul_precision"] == "float32"


def test_compile_cache_falls_back_to_checkout_dir(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config(monkeypatch)
    path = runtime.configure_runtime()
    assert path == runtime.DEFAULT_CACHE_DIR
    assert path == str(runtime.REPO_ROOT) + "/.jax_cache"
    assert calls["jax_compilation_cache_dir"] == path
    assert calls["jax_default_matmul_precision"] == "float32"


def test_roofline_h100_table():
    out = roofline.roofline(
        1e-3, flops=6.7e9, bytes_=3.35e8, device_kind="NVIDIA H100 80GB HBM3"
    )
    assert out["pct_f32_peak"] == pytest.approx(10.0)
    assert out["pct_hbm_peak_logical"] == pytest.approx(10.0)
    assert out["pct_tensor_core_bf16_peak"] == pytest.approx(0.7)
    assert out["bound"] == "f32 compute"
    assert not any("mxu" in k for k in out)


def test_roofline_unknown_device_raises():
    with pytest.raises(ValueError, match="no peak table"):
        roofline.roofline(1e-3, 1e9, 1e6, device_kind="cpu")
