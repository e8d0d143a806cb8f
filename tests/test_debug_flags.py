"""Debug/robustness flags mirroring the reference option table
(src/meth_main.c:58-109): --print-raw (f5cio.c:380-388),
--debug-break (meth_main.c:640), --skip-unreadable (f5cio.c:308-318),
--profile-cpu (stage detail).  These run at the batch-loader level —
no device work needed."""

import io
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

ECOLI = "/root/reference/test/ecoli_2kb_region"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(not os.path.isdir(ECOLI),
                                reason="dataset missing")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from f5c_tpu.io.bam import write_bam
    from f5c_tpu.io.fasta import FastaIndex
    from f5c_tpu.io.readdb import ReadDB

    tmp = tmp_path_factory.mktemp("dbg")
    fa = FastaIndex(os.path.join(ECOLI, "reads.fasta"))
    names = fa.names()[:3]
    genome = str(tmp / "genome.fa")
    reads = str(tmp / "reads.fasta")
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
    bam = str(tmp / "self.bam")
    write_bam(bam, [(n, fa.entries[n].length) for n in names], recs)
    ReadDB(reads).build(fast5_dirs=[os.path.join(ECOLI, "fast5_files")])
    return bam, genome, reads, names


def _pipe(dataset, **kw):
    from f5c_tpu.pipeline.runner import Options, Pipeline

    bam, genome, reads, _ = dataset
    return Pipeline(bam, genome, reads, Options(min_mapq=0, **kw))


def test_print_raw_dumps_adc_in_bam_order(dataset):
    from f5c_tpu.io.fast5 import read_fast5_signal

    bam, genome, reads, names = dataset
    pipe = _pipe(dataset, print_raw=True)
    buf = io.StringIO()
    with redirect_stdout(buf):
        batches = list(pipe.batches())
    out = buf.getvalue().splitlines()
    headers = [ln for ln in out if ln.startswith(">")]
    assert len(headers) == len(names)
    for ln, n in zip(headers, names):           # BAM order preserved
        fields = ln.split("\t")
        assert fields[0] == f">{n}"
        assert fields[1].startswith("PATH:")
        nsample = int(fields[2][len("LN:"):])
        sig = read_fast5_signal(fields[1][len("PATH:"):], read_id=n)
        assert nsample == sig.nsample
    # sample lines: ints, tab-separated, count == LN
    first_samples = out[out.index(headers[0]) + 1].rstrip("\t").split("\t")
    assert len(first_samples) == int(headers[0].split("LN:")[1])
    int(first_samples[0])


def test_debug_break_stops_after_n_batches(dataset):
    pipe = _pipe(dataset, batch_reads=1, debug_break=2)
    assert len(list(pipe.batches())) == 2
    pipe2 = _pipe(dataset, batch_reads=1)
    assert len(list(pipe2.batches())) == 3


def test_skip_unreadable_no_aborts(dataset):
    from f5c_tpu.pipeline.runner import ReadRecord

    pipe = _pipe(dataset, skip_unreadable=False)
    r = ReadRecord(qname="ghost", read_idx=0, tid=0, pos=0, cigar=[],
                   is_reverse=False, seq="ACGT" * 10,
                   signal_path="/nonexistent.blow5")
    with pytest.raises(SystemExit):
        pipe._populate_read(r, None)
    # default skips and counts
    pipe2 = _pipe(dataset)
    assert pipe2._populate_read(r, None) is False
    assert pipe2.counters["bad_signal"] == 1


def test_profile_detail_report(dataset):
    pipe = _pipe(dataset, profile_detail=True)
    list(pipe.batches())
    pipe.stage_detail["events.load_host"] += 0.0
    buf = io.StringIO()
    pipe.report(f=buf)
    assert "stage detail:" in buf.getvalue()


def test_write_read_dump_roundtrip(dataset, tmp_path):
    """--write-dump caches raw signals in the reference's binary format
    (u64 nsample, f32 raw, f32 dig/offset/range/rate, BAM order,
    f5cio.c:321-344); --read-dump loads from it, and the loaded events
    must be bit-identical to a direct FAST5 load."""
    import struct

    dump = str(tmp_path / "raw.dump")
    pipe_w = _pipe(dataset, write_dump=dump)
    direct = [b for batch in pipe_w.batches() for b in batch]
    assert os.path.getsize(dump) > 0
    # structural check: walk the records
    with open(dump, "rb") as fh:
        n_rec = 0
        while True:
            hdr = fh.read(8)
            if not hdr:
                break
            n = struct.unpack("<Q", hdr)[0]
            if n:
                fh.seek(4 * n + 16, 1)
            n_rec += 1
    assert n_rec == len(direct)

    pipe_r = _pipe(dataset, read_dump=dump)
    cached = [b for batch in pipe_r.batches() for b in batch]
    assert len(cached) == len(direct)
    for a, b in zip(direct, cached):
        assert a.qname == b.qname
        np.testing.assert_array_equal(a.event_means, b.event_means)
        assert a.scaling.shift == b.scaling.shift
        assert a.sample_rate == b.sample_rate


def test_spawn_pool_loader_matches_inline(dataset):
    """num_proc > 1 loads through a spawn ProcessPoolExecutor (the
    default on multi-core hosts when the wave path is off); loaded
    events and scalings must bit-match the inline loader."""
    pipe1 = _pipe(dataset)                      # num_proc=1, inline
    inline = [r for b in pipe1.batches() for r in b]
    pipe2 = _pipe(dataset, num_proc=2)          # spawn pool
    pooled = [r for b in pipe2.batches() for r in b]
    assert len(inline) == len(pooled) > 0
    for a, b in zip(inline, pooled):
        assert a.qname == b.qname
        np.testing.assert_array_equal(a.event_means, b.event_means)
        assert a.scaling.shift == b.scaling.shift
        assert a.scaling.scale == b.scaling.scale
        assert a.nsample == b.nsample


def test_cli_accepts_new_flags():
    import subprocess

    env = dict(os.environ)
    env.update({"JAX_PLATFORMS": "cpu"})
    out = subprocess.run(
        [sys.executable, "-m", "f5c_tpu.cli", "call-methylation", "-h"],
        env=env, capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0
    for flag in ("--print-raw", "--skip-unreadable", "--debug-break",
                 "--profile-cpu", "--events-engine"):
        assert flag in out.stdout, flag
