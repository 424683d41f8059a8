"""The one place that reads the platform and decides the fill executor.

Every device fill in the package asks :func:`fill_executor` which body
serves it:

* ``"cuda"`` on a ``gpu`` platform: the banded fill runs as the CUDA
  kernel in ``ops/cuda/banded_fill.cu`` (built at first use, see
  :mod:`poasta_tpu.ops.cuda_fill`); a build failure raises.
* ``"xla"`` on ``cpu``: the plain ``lax.scan`` bodies.
* any other platform raises: no kernel of this package targets it.

Shapes the CUDA kernel cannot take (shared-memory budget, see
:func:`poasta_tpu.ops.banded_fill.cuda_fits`) are routed to the XLA body
by a rule on the shapes alone, before the call, and counted by the
caller; nothing catches a kernel failure and serves another route.
"""

from __future__ import annotations

import functools
from typing import Optional

EXECUTORS = {"gpu": "cuda", "cpu": "xla"}


def platform() -> str:
    """Platform of the default JAX backend (``gpu``, ``cpu``, ...)."""
    import jax

    return jax.default_backend()


def executor_for(plat: str) -> str:
    """Fill executor for a platform name; raises for an unsupported one."""
    try:
        return EXECUTORS[plat]
    except KeyError:
        raise RuntimeError(
            f"no fill executor for platform {plat!r}: poasta_tpu runs on "
            "an NVIDIA GPU (CUDA kernel) or the CPU (XLA bodies)") from None


@functools.lru_cache(maxsize=None)
def _ready_executor(plat: str) -> str:
    ex = executor_for(plat)
    if ex == "cuda":
        from ..ops import cuda_fill

        cuda_fill.ensure_registered()  # builds the library; raises on failure
    return ex


def fill_executor(plat: Optional[str] = None) -> str:
    """``"cuda"`` or ``"xla"`` for ``plat`` (default: the JAX backend).

    On a GPU the first call builds and registers the CUDA library."""
    return _ready_executor(plat or platform())


def has_accelerator() -> bool:
    """True when the default backend is a device the package drives."""
    return executor_for(platform()) != "xla"
