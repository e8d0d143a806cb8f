"""Which implementation runs each device op on this platform.

One place maps ``jax.default_backend()`` to the device routes:

- ``"gpu"``: ABEA through the CUDA kernel (``ops/abea_cuda.py``); the
  profile-HMM scorer, Viterbi and event detection through plain XLA
  (``ops/hmm.py``, ``ops/events_device.py``).
- ``"cpu"``: plain XLA for every op (tests, ``--device cpu``).
- any other backend: an error.

On the GPU there is no fallback: a kernel library that cannot be built
or loaded fails the run.
"""

from __future__ import annotations

import jax

GPU = "gpu"
CPU = "cpu"


def platform() -> str:
    """The JAX backend, checked against the platforms with routes."""
    backend = jax.default_backend()
    if backend not in (GPU, CPU):
        raise RuntimeError(
            f"no device route for JAX backend {backend!r}: f5c-tpu runs "
            "on an NVIDIA GPU (CUDA) or on the CPU")
    return backend


def abea_impl():
    """The ABEA launch implementation for this platform; both take
    ``(ev_pool, rk_pool, meta_i, meta_f, byte_off, level_mean,
    level_stdv, level_log_stdv, **AbeaLaunch.statics)`` and return
    ``(flat, start_e, n)``."""
    if platform() == GPU:
        from . import abea_cuda

        abea_cuda.load()
        return abea_cuda.abea_align_cuda
    from .abea import abea_align_xla

    return abea_align_xla
