"""Shared test fixtures.

Tests run on the CPU with a virtual 8-device mesh, so sharding paths run
without a GPU.  Tests marked ``gpu`` take the ``gpu`` fixture, which
skips them unless JAX's backend is a GPU; on the card run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

# Must be set before jax is imported anywhere.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"
ECOLI_DIR = os.path.join(REFERENCE_DIR, "test", "ecoli_2kb_region")
SINGLE_READ_DIR = os.path.join(ECOLI_DIR, "single_read")

READ1_FAST5 = os.path.join(
    ECOLI_DIR,
    "fast5_files",
    "odw_genlab4209_20161213_FN_MN16303_sequencing_run_sample_id_32395_"
    "ch85_read2098_strand.fast5",
)

needs_reference = pytest.mark.skipif(
    not os.path.isdir(ECOLI_DIR), reason="reference test data not mounted"
)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (decided here, never at import)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: on the card run "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return jax.devices()[0]


@pytest.fixture(scope="session")
def ecoli_dir():
    if not os.path.isdir(ECOLI_DIR):
        pytest.skip("reference test data not mounted")
    return ECOLI_DIR


@pytest.fixture(scope="session")
def read1_signal():
    from f5c_tpu.io.fast5 import read_fast5_signal

    if not os.path.isfile(READ1_FAST5):
        pytest.skip("reference test data not mounted")
    return read_fast5_signal(READ1_FAST5)


@pytest.fixture(scope="session")
def read1_events(read1_signal):
    from f5c_tpu.ops.events_ref import detect_events

    return detect_events(read1_signal.to_pa())


@pytest.fixture(scope="session")
def read1_seq():
    path = os.path.join(SINGLE_READ_DIR, "read1.fasta")
    if not os.path.isfile(path):
        pytest.skip("reference test data not mounted")
    seq = []
    with open(path) as f:
        for line in f:
            if not line.startswith(">"):
                seq.append(line.strip())
    return "".join(seq)


def assert_f5c_tolerance(ours, truth, max_deviant_frac=0.0):
    """The reference's float oracle: |x-truth| <= 0.1|truth| + 0.02,
    with at most ``max_deviant_frac`` of rows allowed to deviate
    (scripts/test.awk:7-13, scripts/test.sh:47-57)."""
    ours = np.asarray(ours, dtype=np.float64)
    truth = np.asarray(truth, dtype=np.float64)
    ok = np.abs(ours - truth) <= 0.1 * np.abs(truth) + 0.02
    frac_bad = 1.0 - ok.mean() if ok.size else 0.0
    assert frac_bad <= max_deviant_frac, (
        f"{(~ok).sum()}/{ok.size} values outside f5c tolerance "
        f"(allowed {max_deviant_frac:.0%}); worst diff "
        f"{np.max(np.abs(ours - truth)):.4f}"
    )
