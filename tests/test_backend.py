"""The capability decision, the compile-cache rule and the CUDA build
command: what the package decides about its platform, from the CPU."""

import os
import subprocess
from pathlib import Path

import pytest

from poasta_tpu.ops import cuda_fill
from poasta_tpu.utils import backend, compile_cache

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("plat,expect", [("gpu", "cuda"), ("cpu", "xla")])
def test_executor_for_platform(plat, expect):
    assert backend.executor_for(plat) == expect


@pytest.mark.parametrize("plat", ["rocm", "METAL", "", "neuron"])
def test_unsupported_platform_raises(plat):
    with pytest.raises(RuntimeError, match="no fill executor"):
        backend.executor_for(plat)


@pytest.mark.parametrize("platforms,markexpr,expect", [
    ("cpu", "not slow", False),      # the CPU suite
    ("", "", False),
    ("", "gpu", True),               # pytest -m gpu on the card
    ("cuda", "", True),
    ("cuda,cpu", "not slow", True),
    ("cpu", "gpu or slow", False),
])
def test_gpu_run_rule(platforms, markexpr, expect):
    """Which test runs keep JAX's own platform (and fail, not skip, the
    ``gpu`` tests when no GPU shows up)."""
    from conftest import wants_gpu

    assert wants_gpu(platforms, markexpr) is expect


def test_fill_executor_on_cpu_is_xla():
    assert backend.platform() == "cpu"
    assert backend.fill_executor() == "xla"
    assert backend.fill_executor("cpu") == "xla"
    assert not backend.has_accelerator()


def test_gpu_executor_registers_the_cuda_library(monkeypatch):
    """On a GPU the decision builds and registers the CUDA library first;
    a build failure raises instead of choosing another executor."""
    calls = []
    monkeypatch.setattr(cuda_fill, "ensure_registered",
                        lambda: calls.append(1))
    backend._ready_executor.cache_clear()
    try:
        assert backend.fill_executor("gpu") == "cuda"
        assert calls == [1]

        def broken():
            raise RuntimeError("nvcc failed")

        backend._ready_executor.cache_clear()
        monkeypatch.setattr(cuda_fill, "ensure_registered", broken)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            backend.fill_executor("gpu")
    finally:
        backend._ready_executor.cache_clear()


@pytest.mark.parametrize("env,expect", [
    ({}, compile_cache.CACHE_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
    ({"POASTA_TPU_NO_COMPILE_CACHE": "1"}, None),
])
def test_compile_cache_rule(env, expect):
    assert compile_cache.cache_dir_for(env) == expect


def test_compile_cache_lives_in_the_checkout_and_is_ignored():
    path = Path(compile_cache.CACHE_DIR)
    assert path.parent == REPO and path.name == ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_compile_cache_sets_nothing_when_env_decides(monkeypatch):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    compile_cache.enable_persistent_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_nvcc_command_targets_hopper():
    cmd = cuda_fill.nvcc_command("nvcc", Path("a.cu"), Path("b.so"),
                                 "/inc")
    assert cmd[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    for flag in ("-std=c++17", "-O3", "-shared"):
        assert flag in cmd
    assert cmd[cmd.index("-Xcompiler") + 1] == "-fPIC"
    assert cmd[cmd.index("-I") + 1] == "/inc"
    assert cmd[cmd.index("-o") + 1] == "b.so" and cmd[-1] == "a.cu"


def test_library_path_is_ignored_and_keyed_by_source():
    p = cuda_fill.library_path("/inc")
    assert p.parent == cuda_fill.BUILD_DIR
    assert p.name.startswith("libbanded_fill-") and p.suffix == ".so"
    assert cuda_fill.SOURCE.exists()
    assert cuda_fill.library_path("/other") != p  # command is in the key
    rel = p.relative_to(REPO)
    out = subprocess.run(["git", "check-ignore", "-q", str(rel)], cwd=REPO)
    assert out.returncode == 0, f"{rel} is not git-ignored"


def test_find_nvcc_raises_without_toolkit(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_fill.find_nvcc()


@pytest.mark.parametrize("Wb,lpt,width", [
    (128, 4, 128), (4096, 4, 4096), (4224, 8, 4352), (5120, 8, 5120),
    (8192, 8, 8192)])
def test_lanes_per_thread_and_width(Wb, lpt, width):
    from poasta_tpu.ops.banded_fill import cuda_width, lanes_per_thread

    assert lanes_per_thread(Wb) == lpt
    assert cuda_width(Wb) == width
    assert width // lanes_per_thread(width) <= 1024
    assert (width // lanes_per_thread(width)) % 32 == 0
