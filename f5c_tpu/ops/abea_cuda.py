"""ABEA on the GPU: the CUDA kernel in ``abea_cuda.cu`` as a JAX op.

The source is compiled with ``nvcc`` for Hopper (``sm_90a``) at first
use into ``.build/`` (``buildcache``: keyed by source, flags, nvcc
version, JAX version and the XLA FFI headers' contents), loaded with ``ctypes`` and registered as the XLA FFI target
``f5c_abea_align`` on the CUDA platform.  There is no fallback: if the
library cannot be built or loaded, ``abea_align_cuda`` raises.

Inputs and outputs follow the launch contract of ``ops/abea.py``
(``plan_launch``): batch-wide event and rank pools, per-read metadata
rows, the ragged output offsets; out come the packed walk directions,
the walk's start event and its length per read.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import ABEA_EPSILON_SKIP, ABEA_LP_TRIM_P

TARGET = "f5c_abea_align"
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "abea_cuda.cu")
# -fmad=false: no FMA contraction anywhere, so the f32 emission and the
# double transition sums round exactly as the NumPy oracle's
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
LP_SKIP = float(np.log(ABEA_EPSILON_SKIP))
LP_TRIM = float(np.log(ABEA_LP_TRIM_P))

_lock = threading.Lock()
_state: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): "
                           "the GPU ABEA kernel cannot be built")
    return found


def build() -> str:
    """Compile the kernel library (once per source, flags, nvcc, JAX and
    FFI headers)."""
    from ..buildcache import build as _build, keyed_path, tree_digest

    cc = nvcc()
    include = jax.ffi.include_dir()
    cmd = [cc, *NVCC_FLAGS, f"-I{include}", SRC]
    version = subprocess.run([cc, "--version"], capture_output=True,
                             text=True).stdout
    return _build(keyed_path("libabea_cuda", SRC, cmd, version,
                             jax.__version__, tree_digest(include)), cmd)


def load() -> float:
    """Build (if needed), load and register the FFI target; returns the
    seconds spent.  Raises RuntimeError when the library is unusable."""
    with _lock:
        if "lib" in _state:
            return 0.0
        import time

        t0 = time.perf_counter()
        path = build()
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.F5cAbeaAlign), platform="CUDA")
        _state["lib"] = lib
        _state["secs"] = time.perf_counter() - t0
        return _state["secs"]


@functools.partial(jax.jit, static_argnames=("E", "K", "n_trace_bands",
                                             "cap"))
def abea_align_cuda(ev_pool, rk_pool, meta_i, meta_f, byte_off,
                    level_mean, level_stdv, level_log_stdv, *,
                    E: int, K: int, n_trace_bands: int, cap: int):
    """Fill + walk for every read of the launch in one FFI call.

    ``E``/``K`` (the XLA route's padded sizes) are unused here; the
    kernel works on the ragged pools directly.  ``n_trace_bands`` bounds
    the summed band count (the trace scratch is 32 B per band)."""
    del E, K
    rk = rk_pool.astype(jnp.int32)
    # per-kmer model rows gathered once (a pure gather: exact values);
    # the kernel reads one 16-byte row per cell
    kparams = jnp.stack([level_mean[rk], level_stdv[rk],
                         level_log_stdv[rk], jnp.zeros_like(level_mean[rk])],
                        axis=-1)
    B = meta_i.shape[0]
    flat, start_e, n, _trace = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((cap,), jnp.uint8),
         jax.ShapeDtypeStruct((B,), jnp.int32),
         jax.ShapeDtypeStruct((B,), jnp.int32),
         jax.ShapeDtypeStruct((n_trace_bands * 8,), jnp.uint32)),
    )(ev_pool, kparams, meta_i, meta_f, byte_off,
      lp_skip=np.float64(LP_SKIP), lp_trim=np.float64(LP_TRIM))
    return flat, start_e, n
