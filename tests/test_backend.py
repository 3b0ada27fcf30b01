"""The platform map, the compile-cache helper, the peak table and the
launcher's per-station card placement."""

import os

import pytest

from vlite_fast import backend
from vlite_fast.models import search as search_mod
from vlite_fast.utils import perf


def test_dedisp_engine_cpu():
    assert backend.dedisp_engine("cpu") == "subband"


def test_dedisp_engine_gpu():
    assert backend.dedisp_engine("gpu") == "pallas"


def test_dedisp_engine_unknown_platform_raises():
    with pytest.raises(ValueError, match="no dedispersion engine"):
        backend.dedisp_engine("rocm")


def test_resolve_engine_follows_backend():
    # conftest pins this process to the CPU backend
    assert search_mod.resolve_engine("auto") == "subband"
    assert search_mod.resolve_engine("fourier") == "fourier"


def test_search_dedisperse_rejects_unknown_engine():
    with pytest.raises(ValueError, match="unknown dedispersion engine"):
        search_mod.dedisperse("gather2", None, None, 0)


def test_compile_cache_dir_env_set():
    env = {"JAX_COMPILATION_CACHE_DIR": "/somewhere/cache"}
    assert backend.compile_cache_dir(env) is None


def test_compile_cache_dir_env_unset():
    path = backend.compile_cache_dir({})
    assert path == os.path.join(backend.REPO_ROOT, ".jax_cache")
    # the repo root is the checkout that holds the package
    assert os.path.isdir(os.path.join(os.path.dirname(path), "vlite_fast"))


def test_enable_compile_cache_sets_nothing_when_env_set(monkeypatch):
    import jax
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/x/cache")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert backend.enable_compile_cache() == "/x/cache"
    assert calls == []


def test_enable_compile_cache_sets_repo_dir_when_unset(monkeypatch):
    import jax
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    path = backend.enable_compile_cache()
    assert calls == [("jax_compilation_cache_dir", path)]


def test_peaks_h100():
    p = perf.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_tflops"] == 989.0 and p["tf32_tflops"] == 495.0
    assert p["hbm_gbps"] == 3350.0 and p["power_w"] == 700.0
    assert "data sheet" in p["source"]


def test_peaks_unknown_device_raises():
    with pytest.raises(KeyError, match="no published peaks"):
        perf.peaks("cpu")


def test_placement_shared_card_gets_memory_share():
    mode, envs = backend.station_placement(3, 1)
    assert mode == "shared"
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "0", "0"]
    shares = [float(e["XLA_PYTHON_CLIENT_MEM_FRACTION"]) for e in envs]
    assert shares == [0.3, 0.3, 0.3]


def test_placement_uneven_sharing():
    mode, envs = backend.station_placement(3, 2)
    assert mode == "shared"
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "0"]
    # card 0 holds two stations, card 1 one: shares sum below the budget
    assert [e["XLA_PYTHON_CLIENT_MEM_FRACTION"] for e in envs] == \
        ["0.45", "0.90", "0.45"]


def test_placement_one_card_each():
    mode, envs = backend.station_placement(4, 4)
    assert mode == "pinned"
    assert [e["CUDA_VISIBLE_DEVICES"] for e in envs] == ["0", "1", "2", "3"]
    assert all("XLA_PYTHON_CLIENT_MEM_FRACTION" not in e for e in envs)


def test_placement_no_card():
    assert backend.station_placement(2, 0) == ("none", [{}, {}])
