"""Golden end-to-end gate: the PRODUCTION pipeline vs vendored
oracle-generated fixtures on a synthetic genome with indels, reverse
strands, soft clips and mismatches (tests/data/golden/, generated by
scripts/make_golden_fixtures.py from the pure-NumPy oracle stack).

This is the offline substitute for the reference's genome-true meth.exp
oracle (scripts/test.sh:59-103, draft.fa stripped from this checkout):
it pins end-to-end LLR semantics against alignment shapes the
self-alignment datasets cannot produce.  Comparison uses the
reference's awk tolerance: float cols |x - t| <= 0.1|t| + 0.02, with 0
deviant rows allowed at this dataset size (scripts/test.awk:7-13).

Unlike the ecoli-based suites, the dataset is fully vendored, so this
gate runs in CI (no /root/reference needed).
"""

import gzip
import io
import os
import shutil

import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")

pytestmark = pytest.mark.skipif(
    not os.path.isfile(os.path.join(GOLDEN, "meth.exp")),
    reason="golden fixtures not generated")


def _tolerant_compare(ours: str, truth: str, float_cols: set[int],
                      max_deviant: float = 0.0):
    """scripts/compare_tsv.py semantics, in-process."""
    from f5c_tpu.oracle import tolerant_compare

    tolerant_compare(ours, truth, float_cols, max_deviant)


@pytest.fixture(scope="module")
def golden_pipeline(tmp_path_factory):
    """Production Pipeline over the vendored dataset (indexes are built
    in tmp so the vendored tree stays read-only)."""
    from f5c_tpu.io.readdb import ReadDB
    from f5c_tpu.pipeline.runner import Options, Pipeline

    tmp = str(tmp_path_factory.mktemp("golden"))
    for f in ("genome.fa", "reads.fasta", "reads.bam", "signals.blow5"):
        shutil.copy(os.path.join(GOLDEN, f), tmp)
    reads = os.path.join(tmp, "reads.fasta")
    slow5 = os.path.join(tmp, "signals.blow5")
    ReadDB(reads).build(slow5_path=slow5)
    opt = Options(min_mapq=0, meth_out_version=1, slow5_path=slow5)
    pipe = Pipeline(os.path.join(tmp, "reads.bam"),
                    os.path.join(tmp, "genome.fa"), reads, opt)
    return pipe, tmp


def _check_meth(pipe):
    out = io.StringIO()
    pipe.call_methylation(out=out)
    assert pipe.counters["processed"] == 6
    truth = open(os.path.join(GOLDEN, "meth.exp")).read()
    # float cols: log_lik_ratio, log_lik_methylated, log_lik_unmethylated
    _tolerant_compare(out.getvalue(), truth, {4, 5, 6})


def _check_eventalign(tmp):
    from types import SimpleNamespace

    from f5c_tpu.pipeline.eventalign import run_eventalign
    from f5c_tpu.pipeline.runner import Options, Pipeline

    # fresh pipeline: the meth run consumed the BAM iterator
    opt = Options(min_mapq=0, slow5_path=os.path.join(tmp,
                                                      "signals.blow5"))
    pipe = Pipeline(os.path.join(tmp, "reads.bam"),
                    os.path.join(tmp, "genome.fa"),
                    os.path.join(tmp, "reads.fasta"), opt)
    out = io.StringIO()
    summ_path = os.path.join(tmp, "summary.tsv")
    run_eventalign(pipe, SimpleNamespace(summary=summ_path), out=out)

    truth = gzip.open(os.path.join(GOLDEN, "eventalign.exp.gz"),
                      "rt").read()
    # float cols: event mean/stdv/duration, model mean/stdv, std level
    _tolerant_compare(out.getvalue(), truth, {6, 7, 8, 10, 11, 12})

    ours_sum = open(summ_path).read()
    truth_sum = open(os.path.join(GOLDEN,
                                  "eventalign.summary.exp")).read()
    # the summary's fast5_path column is machine-specific; normalise it
    def _norm(text):
        rows = []
        for ln in text.rstrip("\n").split("\n"):
            c = ln.split("\t")
            if len(c) > 2:
                c[2] = os.path.basename(c[2])
            rows.append("\t".join(c))
        return "\n".join(rows) + "\n"

    # float cols: total_duration, shift, scale, drift, var
    _tolerant_compare(_norm(ours_sum), _norm(truth_sum),
                      {9, 10, 11, 12, 13})


def test_golden_call_methylation(golden_pipeline):
    """The suite's default: 8 virtual devices, the mesh paths."""
    pipe, _ = golden_pipeline
    _check_meth(pipe)


def test_golden_eventalign(golden_pipeline):
    _check_eventalign(golden_pipeline[1])


def test_golden_call_methylation_one_device(golden_pipeline, monkeypatch):
    """The one-device wave schedule (what one card runs)."""
    from f5c_tpu.pipeline.runner import Options, Pipeline

    monkeypatch.setenv("F5C_TPU_MESH", "0")
    tmp = golden_pipeline[1]
    slow5 = os.path.join(tmp, "signals.blow5")
    pipe = Pipeline(os.path.join(tmp, "reads.bam"),
                    os.path.join(tmp, "genome.fa"),
                    os.path.join(tmp, "reads.fasta"),
                    Options(min_mapq=0, meth_out_version=1,
                            slow5_path=slow5))
    assert pipe.supports_waves()
    _check_meth(pipe)


def test_golden_eventalign_one_device(golden_pipeline, monkeypatch):
    monkeypatch.setenv("F5C_TPU_MESH", "0")
    _check_eventalign(golden_pipeline[1])


@pytest.mark.parametrize("engine", ["python", "device"])
def test_golden_eventalign_engine(golden_pipeline, monkeypatch, engine):
    """The lockstep engines (host chunk DPs; batched device Viterbi)
    meet the same gate as the default whole-read native loop."""
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", engine)
    _check_eventalign(golden_pipeline[1])
