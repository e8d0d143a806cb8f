"""Whole-dataset parity of the production align path (the platform's
ABEA route, ops/route.py) against the reference's debug fixtures — runs
in the default suite so full-set QC drift in the device route fails
pytest.  The NumPy-oracle flavour lives in
test_fullset_oracle.py behind -m slow."""

import os
import re

import numpy as np
import pytest

from conftest import ECOLI_DIR, needs_reference

pytestmark = [needs_reference]


@pytest.fixture(scope="module")
def aligned_records():
    import jax

    if jax.default_backend() == "cpu":
        pytest.skip("the full set on the XLA route is minutes of CPU")
    from f5c_tpu import native
    from f5c_tpu.io.bam import BamReader
    from f5c_tpu.io.fasta import FastaIndex
    from f5c_tpu.io.fast5 import read_fast5_signal
    from f5c_tpu.io.readdb import scan_fast5_dirs
    from f5c_tpu.models import builtin_model
    from f5c_tpu.pipeline.runner import Options, Pipeline, ReadRecord

    if not native.available():
        pytest.skip("native host library unavailable")
    model = builtin_model("dna_r9_nucleotide")
    bam = BamReader(os.path.join(ECOLI_DIR, "reads.sorted.bam"))
    fa = FastaIndex(os.path.join(ECOLI_DIR, "reads.fasta"))
    paths = scan_fast5_dirs([os.path.join(ECOLI_DIR, "fast5_files")])
    batch = []
    for i, rec in enumerate(r for r in bam if not r.is_unmapped):
        seq = fa.fetch(rec.qname)
        sig = read_fast5_signal(paths[rec.qname])
        et = native.detect_events(sig.to_pa())
        ranks = native.kmer_ranks(seq, model.k)
        sc = native.mom_scalings(et.mean, ranks, model.level_mean)
        rr = ReadRecord(
            qname=rec.qname, read_idx=i, tid=rec.tid, pos=rec.pos,
            cigar=rec.cigar, is_reverse=rec.is_reverse, seq=seq,
            event_means=et.mean, n_events=et.mean.shape[0], scaling=sc)
        rr.scaling_mom = sc      # r.scaling becomes recalibrated later
        batch.append(rr)
    assert len(batch) == 143
    pipe = Pipeline.bare(Options(), model)
    pipe.align_batch(batch)
    return batch


def test_fullset_mom_vs_fixture(aligned_records):
    exp = []
    for ln in open(os.path.join(ECOLI_DIR, "est_scalings.exp")):
        m = re.search(r"shift: (-?[\d.]+)", ln)
        if m:
            exp.append(("shift", float(m.group(1))))
            continue
        m = re.search(r"scale: (-?[\d.]+)", ln)
        if m:
            exp.append(("scale", float(m.group(1))))
    shifts = [v for k, v in exp if k == "shift"]
    scales = [v for k, v in exp if k == "scale"]
    assert len(shifts) == len(aligned_records)
    for i, r in enumerate(aligned_records):
        assert abs(r.scaling_mom.shift - shifts[i]) <= 0.05, r.qname
        assert abs(r.scaling_mom.scale - scales[i]) <= 0.05, r.qname


def test_fullset_device_align_vs_fixture(aligned_records):
    exp = []
    for ln in open(os.path.join(ECOLI_DIR, "adaptive.exp")):
        m = re.match(r"sum_emission (-?[\d.]+), n_aligned_events ([\d.]+),"
                     r" avg_log_emission (-?[\d.]+)", ln)
        if m:
            exp.append(tuple(float(x) for x in m.groups()))
    assert len(exp) == len(aligned_records)
    for i, r in enumerate(aligned_records):
        assert getattr(r, "align_n_pairs", None) is not None, r.qname
        assert abs(r.align_n_pairs - exp[i][1]) <= 2, \
            f"{r.qname}: n_aligned {r.align_n_pairs} vs {exp[i][1]}"
        avg = r.align_sum_emission / max(r.align_n_pairs, 1)
        assert abs(avg - exp[i][2]) <= 0.01, f"{r.qname}: avg emission"


def test_fullset_device_recalib_vs_fixture(aligned_records):
    exp = []
    for ln in open(os.path.join(ECOLI_DIR, "recalib_scalings.exp")):
        m = re.match(r"shift: (-?[\d.]+) scale: (-?[\d.]+) var: (-?[\d.]+)",
                     ln)
        exp.append(tuple(float(x) for x in m.groups()))
    got = [(r.scaling.shift, r.scaling.scale, r.scaling.var)
           for r in aligned_records
           if not r.status and r.scaling is not None]
    assert len(got) == len(exp)
    for i, (a, b) in enumerate(zip(got, exp)):
        assert all(abs(x - y) <= 0.05 for x, y in zip(a, b)), \
            f"read {i}: recal {a} vs {b}"
