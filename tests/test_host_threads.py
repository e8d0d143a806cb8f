"""Host thread-pool parity: the full 112-read call-methylation
pipeline with F5C_TPU_POST_THREADS=4 must be byte-identical to the
serial run.

The `_host_pool` threads carry the three hot host stages (signal load +
event detect via prep_read, postalign/QC decode, CpG group collection)
on multi-core hosts — the role of the reference's work-stealing
pthread pool (src/f5c.c:574-679).  This pins the claim that threading
changes nothing but wall time in the default suite.
"""

import io
import os
import sys

import pytest

ECOLI = "/root/reference/test/ecoli_2kb_region"

pytestmark = pytest.mark.skipif(not os.path.isdir(ECOLI),
                                reason="dataset missing")


def _run_meth(tmp, n_threads: int) -> str:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    from f5c_tpu.pipeline.runner import Options, Pipeline

    bam, genome, reads, _n, slow5 = bench.setup_dataset(str(tmp),
                                                        blow5=True)
    os.environ["F5C_TPU_POST_THREADS"] = str(n_threads)
    try:
        opt = Options(min_mapq=0, meth_out_version=1, slow5_path=slow5)
        pipe = Pipeline(bam, genome, reads, opt)
        out = io.StringIO()
        pipe.call_methylation(out=out)
        assert pipe.counters["processed"] > 100
        return out.getvalue()
    finally:
        os.environ.pop("F5C_TPU_POST_THREADS", None)


def test_post_threads_byte_identical(tmp_path):
    d1 = tmp_path / "serial"
    d2 = tmp_path / "threaded"
    d1.mkdir()
    d2.mkdir()
    serial = _run_meth(d1, 1)
    threaded = _run_meth(d2, 4)
    assert serial == threaded


def _run_eventalign(tmp, n_threads: int) -> str:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from types import SimpleNamespace

    import bench
    from f5c_tpu.pipeline.eventalign import run_eventalign
    from f5c_tpu.pipeline.runner import Options, Pipeline

    bam, genome, reads, _n, slow5 = bench.setup_dataset(str(tmp),
                                                        blow5=True)
    os.environ["F5C_TPU_POST_THREADS"] = str(n_threads)
    os.environ["F5C_TPU_EA_ENGINE"] = "native"
    try:
        import io

        pipe = Pipeline(bam, genome, reads,
                        Options(min_mapq=0, slow5_path=slow5))
        out = io.StringIO()
        run_eventalign(pipe, SimpleNamespace(), out=out)
        assert pipe.counters["processed"] > 100
        return out.getvalue()
    finally:
        os.environ.pop("F5C_TPU_POST_THREADS", None)
        os.environ.pop("F5C_TPU_EA_ENGINE", None)


def test_eventalign_realign_threads_byte_identical(tmp_path):
    """The threaded native realign loop (reads fan out over the pool,
    chunk DPs release the GIL) must not change a byte of TSV output."""
    d1 = tmp_path / "ea1"
    d2 = tmp_path / "ea4"
    d1.mkdir()
    d2.mkdir()
    serial = _run_eventalign(d1, 1)
    threaded = _run_eventalign(d2, 4)
    assert serial == threaded
