"""BAM / FASTA / BGZF / readdb I/O layer tests against real files."""

import os

import numpy as np
import pytest

from f5c_tpu.io.bam import BamReader, passes_load_filters
from f5c_tpu.io.bgzf import BgzfWriter, decompress_all, is_bgzf
from f5c_tpu.io.fasta import FastaIndex, read_fastx, write_fai
from tests.conftest import ECOLI_DIR, needs_reference

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden")


def _indexed_reads(tmp_path, n_reads=40):
    """A generated reads FASTA + BLOW5 indexed by ReadDB (bgzf copy,
    .fai and .gzi)."""
    from f5c_tpu.io.readdb import ReadDB
    from f5c_tpu.models import builtin_model
    from f5c_tpu.sim import (mapped_read, random_genome, read_lengths,
                             write_dataset)

    rng = np.random.default_rng(5)
    genome = random_genome(rng, 200_000)
    reads = [mapped_read(rng, genome, f"r{i}", int(n))
             for i, n in enumerate(read_lengths(rng, n_reads, 3000))]
    paths = write_dataset(str(tmp_path), genome, reads,
                          builtin_model("dna_r9_nucleotide"), rng)
    ReadDB(paths["reads"]).build(slow5_path=paths["blow5"])
    return paths


@needs_reference
def test_bam_reader():
    bam = BamReader(os.path.join(ECOLI_DIR, "reads.sorted.bam"))
    assert bam.references[0] == "tig00000001"
    assert bam.ref_lengths[0] == 4376233
    recs = list(bam)
    assert len(recs) == 144
    # coordinate sorted (unmapped records sort to the end with tid=-1)
    mapped = [r for r in recs if not r.is_unmapped]
    prev = (-1, -1)
    for r in mapped:
        assert (r.tid, r.pos) >= prev
        prev = (r.tid, r.pos)
    # filters: 1 unmapped record in this file
    loaded = [r for r in recs if passes_load_filters(r, min_mapq=0,
                                                     keep_secondary=True)]
    assert len(loaded) == 143
    r0 = loaded[0]
    assert r0.qname == "0a238451-b9ed-446d-a152-badd074006c4"
    assert r0.pos == 14
    assert r0.mapq == 60
    assert len(r0.seq) == r0.l_seq
    assert set(r0.seq) <= set("ACGTN")


@needs_reference
def test_fasta_index_fetch():
    fa = FastaIndex(os.path.join(ECOLI_DIR, "reads.fasta"))
    assert len(fa.names()) == 112
    rid = "fa9ad683-35c5-4dad-a3af-de7a86b1ffa8"
    seq = fa.fetch(rid)
    assert len(seq) > 1000
    assert seq[:10] == fa.fetch(rid, 0, 10)
    assert seq[100:200] == fa.fetch(rid, 100, 200)


@needs_reference
def test_bgzf_fasta_roundtrip(tmp_path):
    # reads.fasta.index is a bgzf-compressed FASTA made by f5c/nanopolish
    idx_path = os.path.join(ECOLI_DIR, "reads.fasta.index")
    assert is_bgzf(idx_path)
    fa_plain = FastaIndex(os.path.join(ECOLI_DIR, "reads.fasta"))
    fa_bgzf = FastaIndex(idx_path)
    rid = "fa9ad683-35c5-4dad-a3af-de7a86b1ffa8"
    assert fa_bgzf.fetch(rid) == fa_plain.fetch(rid)

    # write our own bgzf and read it back
    out = tmp_path / "t.bgz"
    payload = b">x\n" + b"ACGT" * 100000 + b"\n"
    with BgzfWriter(str(out)) as w:
        w.write(payload)
    assert is_bgzf(str(out))
    assert decompress_all(str(out)) == payload


@needs_reference
def test_readdb_build(tmp_path):
    import shutil

    from f5c_tpu.io.readdb import ReadDB

    reads = tmp_path / "reads.fasta"
    shutil.copy(os.path.join(ECOLI_DIR, "reads.fasta"), reads)
    db = ReadDB(str(reads))
    db.build(fast5_dirs=[os.path.join(ECOLI_DIR, "fast5_files")])
    db2 = ReadDB(str(reads)).load()
    rid = "fa9ad683-35c5-4dad-a3af-de7a86b1ffa8"
    assert db2.has_read(rid)
    assert db2.get_signal_path(rid).endswith("ch85_read2098_strand.fast5")
    seq = db2.get_read_sequence(rid)
    assert len(seq) > 1000
    # matches the f5c-generated readdb content
    exp_readdb = os.path.join(ECOLI_DIR, "single_read",
                              "read1.fasta.index.readdb")
    exp = dict(l.strip().split("\t") for l in open(exp_readdb))
    ours = dict(l.strip().split("\t")
                for l in open(db2.readdb_path)) if os.path.getsize(
                    db2.readdb_path) else {}
    assert set(ours) == set(exp)
    for rid in ours:
        assert os.path.basename(ours[rid]) == os.path.basename(exp[rid])


def test_read_fastx(tmp_path):
    p = tmp_path / "t.fq"
    p.write_text("@r1 desc\nACGT\n+\nIIII\n@r2\nGGCC\n+\nJJJJ\n")
    recs = list(read_fastx(str(p)))
    assert recs == [("r1", "ACGT", "IIII"), ("r2", "GGCC", "JJJJ")]
    p2 = tmp_path / "t.fa"
    p2.write_text(">a\nACGT\nACGT\n>b\nTTTT\n")
    recs = list(read_fastx(str(p2)))
    assert recs == [("a", "ACGTACGT", None), ("b", "TTTT", None)]


def test_fasta_gzi_streaming_matches_inmemory(tmp_path):
    """BGZF FASTA with a .gzi block index streams fetches (no whole-file
    decompression) identically to the in-memory path; our index builder
    writes a .gzi the htslib reader accepts (same layout)."""
    import shutil

    import numpy as np

    from f5c_tpu.io.fasta import FastaIndex

    src = _indexed_reads(tmp_path / "ds")["reads"] + ".index"
    for ext in ("", ".fai", ".gzi"):
        shutil.copy(src + ext, tmp_path / ("ix" + ext))
    a = FastaIndex(str(tmp_path / "ix"))
    assert a._gzi is not None
    os.remove(tmp_path / "ix.gzi")
    b = FastaIndex(str(tmp_path / "ix"))
    assert b._gzi is None
    rng = np.random.default_rng(0)
    for n in rng.choice(a.names(), 20):
        assert a.fetch(n) == b.fetch(n)
        L = a.entries[n].length
        s, e = sorted(rng.integers(0, L, 2).tolist())
        assert a.fetch(n, s, e) == b.fetch(n, s, e)


def test_readdb_build_writes_gzi(tmp_path):
    import shutil

    from f5c_tpu.io.bgzf import read_gzi
    from f5c_tpu.io.readdb import ReadDB

    reads = tmp_path / "reads.fasta"
    shutil.copy(os.path.join(GOLDEN, "reads.fasta"), reads)
    shutil.copy(os.path.join(GOLDEN, "signals.blow5"), tmp_path)
    ReadDB(str(reads)).build(slow5_path=str(tmp_path / "signals.blow5"))
    gzi = read_gzi(str(reads) + ".index.gzi")
    assert gzi[0] == (0, 0) and len(gzi) >= 1
