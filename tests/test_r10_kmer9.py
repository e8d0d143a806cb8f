"""R10-style 9-mer models end-to-end.

The reference's R10.4 model tables are stripped from this checkout, so
the k=9 path is validated with synthetic tables: a 4^9 nucleotide model
and a 5^9 CpG model (the real R10 workflow supplies these via
--kmer-model/--meth-model).  This exercises every k-size assumption:
32-bit k-mer ranks (4^9 and 5^9 exceed int16), the rolling 2-bit rank
window, ABEA/HMM with k=9 geometry, and model-file round-tripping.
"""

import io
import os

import numpy as np
import pytest

K = 9


def _synth_models(tmp_path):
    """Write plausible 9-mer model files (nucleotide + CpG)."""
    rng = np.random.default_rng(5)
    n4 = 4 ** K
    means4 = rng.uniform(60.0, 130.0, n4).astype(np.float32)
    stdv4 = rng.uniform(1.2, 3.0, n4).astype(np.float32)
    bases4 = "ACGT"

    def kmer4(i):
        s = []
        for _ in range(K):
            s.append(bases4[i & 3])
            i >>= 2
        return "".join(reversed(s))

    nuc = tmp_path / "r10ish.nucleotide.9mer.model"
    with open(nuc, "w") as f:
        f.write(f"#k\t{K}\n")
        for i in range(n4):
            f.write(f"{kmer4(i)}\t{means4[i]:.2f}\t{stdv4[i]:.2f}\n")

    # CpG model: same levels for ACGT kmers; M-containing kmers shifted
    n5 = 5 ** K
    bases5 = "ACGMT"

    def kmer5(i):
        s = []
        for _ in range(K):
            s.append(bases5[i % 5])
            i //= 5
        return "".join(reversed(s))

    # build by iterating: too slow in pure python for 1.95M rows? ~2s ok
    meth = tmp_path / "r10ish.cpg.9mer.model"
    d2 = {"A": 0, "C": 1, "G": 2, "T": 3}
    with open(meth, "w") as f:
        f.write(f"#k\t{K}\n")
        rng2 = np.random.default_rng(6)
        shift_m = rng2.uniform(-8, 8, n5).astype(np.float32)
        for i in range(n5):
            km = kmer5(i)
            if "M" in km:
                mean = 90.0 + shift_m[i]
                stdv = 2.0
            else:
                idx = 0
                for c in km:
                    idx = (idx << 2) | d2[c]
                mean = means4[idx]
                stdv = stdv4[idx]
            f.write(f"{km}\t{mean:.2f}\t{stdv:.2f}\n")
    return str(nuc), str(meth), means4


@pytest.fixture(scope="module")
def k9_dataset(tmp_path_factory):
    """Synthetic k=9 dataset + REAL-format 9-mer model files."""
    from f5c_tpu.io.bam import write_bam
    from f5c_tpu.io.fast5 import Signal
    from f5c_tpu.io.readdb import ReadDB
    from f5c_tpu.io.slow5 import write_blow5
    from f5c_tpu.models import load_model_file

    tmp_path = tmp_path_factory.mktemp("k9")
    nuc_path, meth_path, means4 = _synth_models(tmp_path)
    nuc = load_model_file(nuc_path)
    assert nuc.k == K and nuc.num_kmers == 4 ** K

    # synthetic read + squiggle drawn from the 9-mer model
    rng = np.random.default_rng(7)
    seq = "".join(rng.choice(list("ACGT"), p=[.3, .2, .2, .3], size=900))
    ranks = nuc.kmer_ranks(seq)
    spb = rng.integers(5, 12, ranks.shape[0])
    sig_pa = np.repeat(nuc.level_mean[ranks], spb)
    sig_pa = sig_pa + rng.normal(0, 1.0, sig_pa.shape[0])
    digitisation, offset, range_ = 8192.0, 0.0, 1500.0
    raw = np.clip(sig_pa * digitisation / range_ - offset, -32000,
                  32000).astype(np.int16)
    sig = Signal(raw=raw, digitisation=digitisation, offset=offset,
                 range=range_, sample_rate=4000.0, read_id="r10-read")
    blow5 = str(tmp_path / "sig.blow5")
    write_blow5(blow5, [sig])

    genome = str(tmp_path / "g.fa")
    reads = str(tmp_path / "r.fa")
    with open(genome, "w") as g:
        g.write(f">ctg\n{seq}\n")
    with open(reads, "w") as r:
        r.write(f">r10-read\n{seq}\n")

    class Rec:
        pass

    rec = Rec()
    rec.qname = "r10-read"
    rec.flag = 0
    rec.tid = 0
    rec.pos = 0
    rec.mapq = 60
    rec.cigar = [(0, len(seq))]
    rec.seq = seq
    bam = str(tmp_path / "b.bam")
    write_bam(bam, [("ctg", len(seq))], [rec])
    ReadDB(reads).build()
    return dict(bam=bam, genome=genome, reads=reads, blow5=blow5,
                nuc=nuc_path, meth=meth_path, seq=seq)


def _check_meth_rows(text: str, seq: str, version: int):
    rows = [ln.split("\t") for ln in text.splitlines()[1:]]
    assert len(rows) > 3
    start_col, llr_col = (2, 5) if version == 2 else (1, 4)
    for r_ in rows:
        start = int(r_[start_col])
        assert seq[start:start + 2] == "CG"
        assert np.isfinite(float(r_[llr_col]))
    return rows


@pytest.mark.slow
def test_k9_end_to_end(k9_dataset):
    from f5c_tpu.pipeline.runner import Options, Pipeline

    d = k9_dataset
    opt = Options(min_mapq=0, meth_out_version=2, slow5_path=d["blow5"],
                  pore="r10", kmer_model_path=d["nuc"],
                  meth_model_path=d["meth"],
                  min_num_events_to_rescale=100)
    p = Pipeline(d["bam"], d["genome"], d["reads"], opt)
    assert p.model.k == K
    assert p.cpg_model.num_kmers == 5 ** K
    buf = io.StringIO()
    p.call_methylation(out=buf)
    assert p.counters["processed"] == 1, p.counters
    _check_meth_rows(buf.getvalue(), d["seq"], version=2)


def test_k9_cli_end_to_end(k9_dataset, capsys):
    """`call-methylation --pore r10 --kmer-model ... --meth-model ...`
    through the real CLI (argparse wiring included) — the k=9 fill +
    HMM production paths driven exactly as a user would.  Ref:
    src/model.c read_model, f5cmisc.h:24-30."""
    from f5c_tpu import cli

    d = k9_dataset
    rc = cli.main([
        "call-methylation", "-b", d["bam"], "-g", d["genome"],
        "-r", d["reads"], "--slow5", d["blow5"], "--pore", "r10",
        "--kmer-model", d["nuc"], "--meth-model", d["meth"],
        "--min-mapq", "0", "--min-recalib-events", "100",
    ])
    assert not rc
    _check_meth_rows(capsys.readouterr().out, d["seq"], version=2)


def test_r10_without_model_is_a_hard_error(tmp_path):
    """--pore r10 must not silently score R10 signal with the R9 6-mer
    table: an explicit --kmer-model is demanded."""
    import pytest

    from f5c_tpu.pipeline.runner import Options, Pipeline

    import os
    import shutil

    from f5c_tpu.io.readdb import ReadDB

    golden = os.path.join(os.path.dirname(__file__), "data", "golden")
    for f in ("reads.bam", "reads.fasta", "signals.blow5"):
        shutil.copy(os.path.join(golden, f), tmp_path)
    bam = str(tmp_path / "reads.bam")
    reads = str(tmp_path / "reads.fasta")
    ReadDB(reads).build(slow5_path=str(tmp_path / "signals.blow5"))
    with pytest.raises(RuntimeError, match="--kmer-model"):
        Pipeline(bam, reads, reads, Options(pore="r10"))
