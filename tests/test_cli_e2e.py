"""Every CLI subcommand end-to-end, in-process (guards the argparse
wiring that unit tests bypass)."""

import contextlib
import io
import os

import numpy as np
import pytest

ECOLI = "/root/reference/test/ecoli_2kb_region"

pytestmark = pytest.mark.skipif(not os.path.isdir(ECOLI),
                                reason="dataset missing")


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    import glob

    from f5c_tpu.io.bam import write_bam
    from f5c_tpu.io.fast5 import read_fast5_signal
    from f5c_tpu.io.fasta import FastaIndex
    from f5c_tpu.io.slow5 import write_blow5

    tmp = str(tmp_path_factory.mktemp("cli"))
    fa = FastaIndex(os.path.join(ECOLI, "reads.fasta"))
    names = fa.names()[:4]
    genome = os.path.join(tmp, "genome.fa")
    reads = os.path.join(tmp, "reads.fasta")
    recs = []

    class Rec:
        pass

    with open(genome, "w") as g, open(reads, "w") as r:
        for i, n in enumerate(names):
            seq = fa.fetch(n)
            g.write(f">{n}\n{seq}\n")
            r.write(f">{n}\n{seq}\n")
            rec = Rec()
            rec.qname = n
            rec.flag = 0
            rec.tid = i
            rec.pos = 0
            rec.mapq = 60
            rec.cigar = [(0, len(seq))]
            rec.seq = seq
            recs.append(rec)
    bam = os.path.join(tmp, "self.bam")
    write_bam(bam, [(n, fa.entries[n].length) for n in names], recs)
    # signals: blow5 of just these reads
    paths = {p.split("ch")[-1]: p for p in glob.glob(
        os.path.join(ECOLI, "fast5_files", "*.fast5"))}
    sigs = []
    for p in sorted(glob.glob(os.path.join(ECOLI, "fast5_files",
                                           "*.fast5"))):
        s = read_fast5_signal(p)
        if s.read_id in names:
            sigs.append(s)
    blow5 = os.path.join(tmp, "sig.blow5")
    write_blow5(blow5, sigs)
    return tmp, bam, genome, reads, blow5, names


def _cli(argv, out_path=None):
    from f5c_tpu.cli import main

    rc = main(argv)
    return rc


def test_index_and_call_methylation(ds, tmp_path):
    tmp, bam, genome, reads, blow5, names = ds
    assert _cli(["index", reads, "--slow5", blow5]) == 0
    assert os.path.exists(reads + ".index.fai")
    assert os.path.exists(blow5 + ".idx")
    meth_out = str(tmp_path / "meth.tsv")
    rc = _cli(["call-methylation", "-b", bam, "-g", genome, "-r", reads,
               "--slow5", blow5, "--min-mapq", "0", "-x", "hpc-gpu",
               "-o", meth_out])
    assert rc == 0
    lines = open(meth_out).read().splitlines()
    assert lines[0].startswith("chromosome\tstrand")
    assert len(lines) > 50

    # meth-freq + freq-merge over the output
    freq_out = str(tmp_path / "freq.tsv")
    assert _cli(["meth-freq", "-i", meth_out, "-o", freq_out]) == 0
    freq_lines = open(freq_out).read().splitlines()
    assert len(freq_lines) > 10
    merged = str(tmp_path / "merged.tsv")
    assert _cli(["freq-merge", freq_out, freq_out, "-o", merged]) == 0
    m0 = [l.split("\t") for l in open(merged).read().splitlines()[1:]]
    f0 = [l.split("\t") for l in freq_lines[1:]]
    # merging a table with itself doubles the counts
    assert int(m0[0][4]) == 2 * int(f0[0][4])


def test_eventalign_cli(ds, tmp_path):
    tmp, bam, genome, reads, blow5, names = ds
    ea_out = str(tmp_path / "ea.tsv")
    summ = str(tmp_path / "summary.tsv")
    rc = _cli(["eventalign", "-b", bam, "-g", genome, "-r", reads,
               "--slow5", blow5, "--min-mapq", "0", "--summary", summ,
               "--signal-index", "-o", ea_out])
    assert rc == 0
    lines = open(ea_out).read().splitlines()
    assert lines[0].split("\t")[-2:] == ["start_idx", "end_idx"]
    assert len(lines) > 1000
    assert len(open(summ).read().splitlines()) == len(names) + 1

    paf_out = str(tmp_path / "ea.paf")
    rc = _cli(["eventalign", "-b", bam, "-g", genome, "-r", reads,
               "--slow5", blow5, "--min-mapq", "0", "--paf",
               "-o", paf_out])
    assert rc == 0
    assert len(open(paf_out).read().splitlines()) == len(names)


def test_resquiggle_cli(ds, tmp_path):
    tmp, bam, genome, reads, blow5, names = ds
    out = str(tmp_path / "rsq.tsv")
    rc = _cli(["resquiggle", reads, "--slow5", blow5, "-o", out])
    assert rc == 0
    lines = open(out).read().splitlines()
    assert lines[0] == "read_id\tkmer_idx\tstart_raw_idx\tend_raw_idx"
    assert len(lines) > 1000
