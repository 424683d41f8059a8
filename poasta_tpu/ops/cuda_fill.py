"""Build, register and call the CUDA banded fill (``cuda/banded_fill.cu``).

The library is compiled from the committed source at first use with
``nvcc`` for Hopper (``sm_90a``) into ``ops/cuda/build/`` (git-ignored);
the file name carries a hash of the source and the command, so an edit
rebuilds it.  To build ahead of time::

    python -m poasta_tpu.ops.cuda_fill

The FFI handler only enqueues the kernel on the stream XLA hands it.
Callers reach it through :func:`cuda_banded_scores`, which takes the
same prepared tables as the XLA body it is checked against
(:func:`poasta_tpu.ops.banded_fill.xla_banded_exec`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).parent / "cuda" / "banded_fill.cu"
BUILD_DIR = Path(__file__).parent / "cuda" / "build"
TARGET = "poasta_banded_fill"
GENCODE = "arch=compute_90a,code=sm_90a"

_state: dict = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the banded fill kernel")


def nvcc_command(nvcc: str, src: Path, out: Path, include_dir: str) -> list:
    return [nvcc, "-gencode", GENCODE, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-I", include_dir, "-o", str(out),
            str(src)]


def library_path(include_dir: str, nvcc: str = "nvcc") -> Path:
    """Output path: hash of the source and of the build command."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(nvcc_command(Path(nvcc).name, SOURCE, Path("out"),
                                   include_dir)).encode())
    return BUILD_DIR / f"libbanded_fill-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date build exists; returns
    its path.  Raises on a failed compile."""
    import jax.ffi

    include_dir = jax.ffi.include_dir()
    nvcc = find_nvcc()
    out = library_path(include_dir, nvcc)
    if out.exists():
        _state.setdefault("build_s", 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(nvcc_command(nvcc, SOURCE, tmp, include_dir),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    _state["build_s"] = time.perf_counter() - t0
    return out


def ensure_registered() -> None:
    """Build (if needed), load and register the FFI target once."""
    if _state.get("registered"):
        return
    import jax.ffi

    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.BandedFill),
                                platform="CUDA")
    _state["lib"] = lib
    _state["registered"] = True


def build_seconds() -> float:
    """Compile time of this process's build (0 when it was cached)."""
    return _state.get("build_s", 0.0)


@functools.lru_cache(maxsize=None)
def _call(B: int):
    import jax
    import jax.numpy as jnp

    return jax.ffi.ffi_call(TARGET, jax.ShapeDtypeStruct((B,), jnp.int32))


def cuda_banded_scores(symbols, pred_slots, pred_valid, pred_wstarts,
                       wstarts, wslots, end_ok, s_ranks, q, lengths, jlo, *,
                       n_nodes: int, W: int, Wb: int, o: int, e: int, x: int,
                       S: int = 0, mq: int = 0, n_min: int = 0,
                       free_start: bool = False, ef: bool = False):
    """(B,) banded scores from the CUDA kernel; arguments as for the XLA
    body (``S > 0`` selects drifting windows, ``ef`` the ends-free end
    rules)."""
    from .banded_fill import lanes_per_thread

    ensure_registered()
    B = int(q.shape[0])
    P = int(pred_slots.shape[1])
    i32 = np.int32
    return _call(B)(
        symbols, pred_slots, pred_valid, pred_wstarts, wstarts, wslots,
        end_ok, s_ranks, q, lengths, jlo,
        n_nodes=i32(n_nodes), P=i32(P), W=i32(W), Wb=i32(Wb), o=i32(o),
        e=i32(e), x=i32(x), S=i32(S), mq=i32(mq), n_min=i32(n_min),
        free_start=i32(bool(free_start)), drift=i32(S > 0),
        ef=i32(bool(ef)), lpt=i32(lanes_per_thread(Wb)))


if __name__ == "__main__":
    print(build())
