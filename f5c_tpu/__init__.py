"""f5c-tpu: nanopore signal analysis in JAX, on an NVIDIA GPU.

A from-scratch JAX/XLA implementation of the capabilities of f5c
(Nanopolish's index / call-methylation / eventalign re-engineered for GPUs):
raw-signal event detection, adaptive banded event alignment (ABEA), scaling
recalibration, and profile-HMM methylation scoring / event re-alignment —
batched, length-binned reads; `jax.sharding.Mesh` data-parallel scaling;
a CUDA kernel for the ABEA band loop (ops/route.py picks each op's
implementation per platform).

Subpackages
-----------
- ``f5c_tpu.models``   pore model tables (k-mer -> current level Gaussians)
- ``f5c_tpu.io``       BLOW5/SLOW5, FAST5, BAM, FASTA/FASTQ, readdb index
- ``f5c_tpu.ops``      device ops: events, ABEA, scaling, profile HMM
- ``f5c_tpu.pipeline`` batch runtime: load -> process -> output pipeline
- ``f5c_tpu.parallel`` device-mesh sharding utilities
"""

__version__ = "0.1.0"

# Persistent XLA compilation cache: the alignment and scoring programs
# are expensive one-time compiles.  JAX_COMPILATION_CACHE_DIR, when set,
# decides alone; otherwise the cache lives at a fixed path inside the
# checkout (listed in .gitignore).
import os as _os

CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")

if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
