"""eventalign: lockstep engine, host/device parity, emitters.

The reference's eventalign oracle needs the dataset's draft genome (not
vendored here), so correctness is established by (a) the Viterbi kernel
matching the loop-faithful oracle (test_viterbi.py), (b) the host C++ and
device lockstep paths producing identical records, and (c) structural
invariants of the emitted formats on real reads self-aligned to
themselves (perfect alignments).
"""

import os

import numpy as np
import pytest

from f5c_tpu import native
from f5c_tpu.pipeline import eventalign as EA

ECOLI = "/root/reference/test/ecoli_2kb_region"

pytestmark = pytest.mark.skipif(not os.path.isdir(ECOLI),
                                reason="dataset missing")


@pytest.fixture(scope="module")
def small_pipeline(tmp_path_factory):
    """Pipeline over 6 self-aligned reads of the vendored dataset."""
    import glob

    from f5c_tpu.io.bam import write_bam
    from f5c_tpu.io.fasta import FastaIndex
    from f5c_tpu.io.readdb import ReadDB
    from f5c_tpu.pipeline.runner import Options, Pipeline

    tmp = str(tmp_path_factory.mktemp("ea"))
    fa = FastaIndex(os.path.join(ECOLI, "reads.fasta"))
    names = fa.names()[:6]
    genome = os.path.join(tmp, "genome.fa")
    reads = os.path.join(tmp, "reads.fasta")
    with open(genome, "w") as g, open(reads, "w") as r:
        for n in names:
            seq = fa.fetch(n)
            g.write(f">{n}\n{seq}\n")
            r.write(f">{n}\n{seq}\n")

    class Rec:
        pass

    recs = []
    for i, n in enumerate(names):
        rec = Rec()
        rec.qname = n
        rec.flag = 0
        rec.tid = i
        rec.pos = 0
        rec.mapq = 60
        rec.cigar = [(0, fa.entries[n].length)]
        rec.seq = fa.fetch(n)
        recs.append(rec)
    bam = os.path.join(tmp, "self.bam")
    write_bam(bam, [(n, fa.entries[n].length) for n in names], recs)
    db = ReadDB(reads)
    db.build(fast5_dirs=[os.path.join(ECOLI, "fast5_files")])
    p = Pipeline(bam, genome, reads, Options(min_mapq=0))
    batch = next(p.batches(keep_raw=True))
    p.align_batch(batch)
    ok = [r for r in batch if not r.status and r.b2e_start is not None]
    refs = [p._fetch_ref_segment(r) for r in ok]
    return p, ok, refs


def test_host_device_paths_agree(small_pipeline):
    """All three engines produce identical records: the whole-read
    native C++ loop, lockstep rounds with host chunk DPs, and lockstep
    rounds with device Viterbi."""
    p, ok, refs = small_pipeline
    loop = EA.EventalignEngine(p.model)
    loop.engine = "native"
    host = EA.EventalignEngine(p.model)
    host.engine = "python"
    dev = EA.EventalignEngine(p.model)
    dev.engine = "device"
    rl = loop.realign_batch(ok, refs)
    rh = host.realign_batch(ok, refs)
    rd = dev.realign_batch(ok, refs)
    for r in ok:
        for other in (rh[id(r)], rd[id(r)]):
            a, b = rl[id(r)], other
            np.testing.assert_array_equal(a.ref_position, b.ref_position)
            np.testing.assert_array_equal(a.event_idx, b.event_idx)
            np.testing.assert_array_equal(a.state, b.state)


def test_auto_engine_probe(small_pipeline, monkeypatch):
    """auto resolves to the whole-read native loop and yields the same
    records; an unknown engine name is refused."""
    p, ok, refs = small_pipeline
    monkeypatch.delenv("F5C_TPU_EA_ENGINE", raising=False)
    eng = EA.EventalignEngine(p.model)
    assert eng.engine == "auto"
    recs = eng.realign_batch(ok, refs)
    assert eng.chosen == "native"
    monkeypatch.setenv("F5C_TPU_EA_ENGINE", "gpu")
    with pytest.raises(ValueError, match="F5C_TPU_EA_ENGINE"):
        EA.EventalignEngine(p.model)
    monkeypatch.delenv("F5C_TPU_EA_ENGINE")
    loop = EA.EventalignEngine(p.model)
    loop.engine = "native"
    rl = loop.realign_batch(ok, refs)
    for r in ok:
        np.testing.assert_array_equal(recs[id(r)].ref_position,
                                      rl[id(r)].ref_position)
        np.testing.assert_array_equal(recs[id(r)].event_idx,
                                      rl[id(r)].event_idx)
        np.testing.assert_array_equal(recs[id(r)].state,
                                      rl[id(r)].state)


def test_records_structure(small_pipeline):
    p, ok, refs = small_pipeline
    engine = EA.EventalignEngine(p.model)
    recs = engine.realign_batch(ok, refs)
    for r in ok:
        rec = recs[id(r)]
        n = rec.ref_position.shape[0]
        assert n > 0
        # self-alignment spans most of the read
        ref_len = len(r.seq)
        assert rec.ref_position.min() >= 0
        assert rec.ref_position.max() <= ref_len - p.model.k
        assert np.all(np.diff(rec.ref_position) >= 0)  # forward strand
        # events strictly within range, no K states stored
        assert rec.event_idx.min() >= 0
        assert rec.event_idx.max() < r.n_events
        assert set(np.unique(rec.state)) <= {1, 2}


def test_emitters(small_pipeline):
    p, ok, refs = small_pipeline
    engine = EA.EventalignEngine(p.model)
    recs_map = engine.realign_batch(ok, refs)
    r = ok[0]
    rec = recs_map[id(r)]
    contig = r.qname
    k = p.model.k

    tsv = EA.emit_tsv(rec, r, p.model, contig, rec.ref_disamb,
                      rec.ref_offset, r.read_idx)
    rows = [l.split("\t") for l in tsv.splitlines()]
    assert len(rows) == rec.ref_position.shape[0]
    assert all(len(row) == 13 for row in rows)
    # model kmers match reference kmers on the forward strand (non-B)
    for row, st in zip(rows[:200], rec.state[:200]):
        if st == 2:
            assert row[2] == row[9]
        else:
            assert row[9] == "N" * k

    # collapse: one row per unique ref position
    tsvc = EA.emit_tsv(rec, r, p.model, contig, rec.ref_disamb,
                       rec.ref_offset, r.read_idx, collapse=True)
    assert len(tsvc.splitlines()) == np.unique(rec.ref_position).shape[0]

    # summary
    s = EA.summarize_alignment(rec, r, nm=0)
    assert s["num_events"] == rec.ref_position.shape[0]
    assert (s["num_stays"] + s["num_steps"] + s["num_skips"]
            == rec.ref_position.shape[0] - 1)
    assert s["reference_span"] > 0.8 * len(r.seq)

    # paf: signal coords consistent with ss operations
    paf = EA.emit_paf(rec, r, contig, len(r.seq), k, rna=False)
    f = paf.strip().split("\t")
    assert f[0] == r.qname
    start_raw, end_raw = int(f[2]), int(f[3])
    assert 0 <= start_raw < end_raw <= int(f[1])
    ss = [x for x in f if x.startswith("ss:Z:")][0][5:]
    # sum of signal-consuming ops == end_raw - start_raw
    import re

    consumed = sum(int(m) for m in re.findall(r"(\d+)[I,]", ss))
    assert consumed == end_raw - start_raw

    # sam v2 single line with required tags
    sam = EA.emit_sam(rec, r, contig, len(r.seq), 2, rna=False)
    assert "\tsi:Z:" in sam and "\tss:Z:" in sam
    sam1 = EA.emit_sam(rec, r, contig, len(r.seq), 1, rna=False)
    assert sam1.startswith(r.qname + ".template\t")
    assert "\tES:i:" in sam1

    # m6anet rows: one per ref position
    m6 = EA.emit_m6anet_tsv(rec, r, p.model, contig, rec.ref_disamb,
                            rec.ref_offset, r.read_idx)
    assert len(m6.splitlines()) == np.unique(rec.ref_position).shape[0]


def test_waved_matches_plain_e2e(tmp_path):
    """run_eventalign through the wave pipeline (per-wave realign
    overlapping device fills, runner.align_batch_waved wave_done) is
    byte-identical to the plain align-then-realign path."""
    import filecmp
    from types import SimpleNamespace

    from f5c_tpu.io.bam import write_bam
    from f5c_tpu.io.fasta import FastaIndex
    from f5c_tpu.io.readdb import ReadDB
    from f5c_tpu.pipeline.eventalign import run_eventalign
    from f5c_tpu.pipeline.runner import Options, Pipeline

    fa = FastaIndex(os.path.join(ECOLI, "reads.fasta"))
    names = fa.names()[:6]
    tmp = str(tmp_path)
    genome = os.path.join(tmp, "genome.fa")
    reads = os.path.join(tmp, "reads.fasta")
    with open(genome, "w") as g, open(reads, "w") as r:
        for n in names:
            seq = fa.fetch(n)
            g.write(f">{n}\n{seq}\n")
            r.write(f">{n}\n{seq}\n")

    class Rec:
        pass

    recs = []
    for i, n in enumerate(names):
        rec = Rec()
        rec.qname = n
        rec.flag = 0
        rec.tid = i
        rec.pos = 0
        rec.mapq = 60
        rec.cigar = [(0, fa.entries[n].length)]
        rec.seq = fa.fetch(n)
        recs.append(rec)
    bam = os.path.join(tmp, "self.bam")
    write_bam(bam, [(n, fa.entries[n].length) for n in names], recs)
    ReadDB(reads).build(fast5_dirs=[os.path.join(ECOLI, "fast5_files")])

    outs = []
    for mode, env in (("waved", {"F5C_TPU_MESH": "0"}),
                      ("plain", {"F5C_TPU_MESH": "1"})):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        os.environ["F5C_TPU_EA_ENGINE"] = "native"
        try:
            pipe = Pipeline(bam, genome, reads, Options(min_mapq=0))
            if mode == "waved" and not pipe.supports_waves():
                pytest.skip("wave pipeline unavailable on this backend")
            out_path = os.path.join(tmp, f"ea_{mode}.tsv")
            with open(out_path, "w") as out:
                run_eventalign(pipe, SimpleNamespace(), out=out)
            outs.append(out_path)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            os.environ.pop("F5C_TPU_EA_ENGINE", None)
    assert filecmp.cmp(outs[0], outs[1], shallow=False)
