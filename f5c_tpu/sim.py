"""Seeded simulator of genome-mapped nanopore datasets.

Everything a pipeline run needs is generated from a seed — nothing is
downloaded: a random genome, reads drawn from it on both strands with
substitutions, insertions, deletions and soft clips, their R9.4 raw
signal (per-kmer dwell at the pore-model level plus Gaussian noise,
int16 ADC samples at 4 kHz), and the files the CLI reads (FASTA genome,
FASTA reads, BAM, BLOW5).

``chip_smoke.py``, ``bench.py``, ``scripts/make_golden_fixtures.py``
and the tests all generate their data here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

DIGITISATION = 8192.0
RANGE = 1467.61
OFFSET = 10.0
SAMPLE_RATE = 4000.0
BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = bytes.maketrans(b"ACGT", b"TGCA")


def random_genome(rng, n: int) -> str:
    return BASES[rng.integers(0, 4, n)].tobytes().decode()


def revcomp(s: str) -> str:
    return s.encode().translate(_COMP)[::-1].decode()


def mutate(rng, s: str, rate: float) -> str:
    """Substitute each base with probability ``rate`` (never by itself)."""
    a = np.frombuffer(s.encode(), np.uint8).copy()
    hit = np.nonzero(rng.random(a.shape[0]) < rate)[0]
    code = np.searchsorted(BASES, a[hit])
    a[hit] = BASES[(code + rng.integers(1, 4, hit.shape[0])) % 4]
    return a.tobytes().decode()


def simulate_signal(rng, seq: str, model, dwell=(6, 13),
                    noise: float = 0.6) -> np.ndarray:
    """Raw int16 ADC samples for a read: ``dwell`` samples per kmer
    (uniform, 450 bases/s at 4 kHz is ~9) at the model level, Gaussian
    noise of ``noise`` x the level's stdv.  No open-pore pads: the
    reference's event detector discards its own trim (events.c:566-575),
    so pad samples would become events and skew the MoM scaling."""
    ranks = model.kmer_ranks(seq)
    n = rng.integers(dwell[0], dwell[1], ranks.shape[0])
    mean = np.repeat(model.level_mean[ranks].astype(np.float64), n)
    sd = np.repeat(model.level_stdv[ranks].astype(np.float64) * noise, n)
    pa = rng.normal(mean, sd)
    raw = np.rint(pa * DIGITISATION / RANGE - OFFSET)
    return np.clip(raw, -32000, 32000).astype(np.int16)


@dataclass
class SimRead:
    qname: str
    read_seq: str        # as basecalled (reverse strand: revcomp)
    flag: int            # 0 or 16
    pos: int             # 0-based leftmost reference position
    cigar: list          # [(op, len)], BAM op codes
    bam_seq: str         # reference-oriented read sequence

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 16)

    @property
    def ref_span(self) -> int:
        return sum(ln for op, ln in self.cigar if op in (0, 2))


def mapped_read(rng, genome: str, qname: str, length: int,
                err: float = 0.01, clip_p: float = 0.3) -> SimRead:
    """One read of ~``length`` reference bases at a random position and
    strand: substitutions at rate ``err``, an insertion or a deletion
    (1-8 bases) about every 10/err bases (none at err=0), a soft clip of
    5-60 random bases at each end with probability ``clip_p``."""
    pos = int(rng.integers(0, len(genome) - length))
    ref = genome[pos:pos + length]
    parts, cigar, i = [], [], 0
    gap = max(int(10 / err), 50) if err > 0 else length
    while i < length:
        m = min(int(rng.integers(gap // 2, 2 * gap)), length - i)
        parts.append(mutate(rng, ref[i:i + m], err))
        cigar.append((0, m))
        i += m
        if err == 0 or i >= length - 10:
            continue
        n = int(rng.integers(1, 9))
        if rng.random() < 0.5:
            parts.append(random_genome(rng, n))
            cigar.append((1, n))
        else:
            n = min(n, length - i - 10)
            cigar.append((2, n))
            i += n
    for end in (0, 1):
        if rng.random() < clip_p:
            n = int(rng.integers(5, 61))
            clip = random_genome(rng, n)
            if end == 0:
                parts.insert(0, clip)
                cigar.insert(0, (4, n))
            else:
                parts.append(clip)
                cigar.append((4, n))
    bam_seq = "".join(parts)
    reverse = bool(rng.random() < 0.5)
    read_seq = revcomp(bam_seq) if reverse else bam_seq
    return SimRead(qname, read_seq, 16 if reverse else 0, pos, cigar,
                   bam_seq)


def read_lengths(rng, n: int, median: float, sigma: float = 0.6,
                 lo: int = 1000, hi: int = 30000) -> np.ndarray:
    """Log-normal read lengths with the given median, clipped."""
    return np.clip(np.rint(median * np.exp(sigma * rng.standard_normal(n))),
                   lo, hi).astype(np.int64)


def write_dataset(outdir: str, genome: str, reads: list[SimRead], model,
                  rng, contig: str = "sim_ctg",
                  rec_press: str = "zlib") -> dict:
    """genome.fa, reads.fasta, reads.bam (coordinate order) and
    signals.blow5 under ``outdir``; returns their paths."""
    from .io.bam import write_bam
    from .io.fast5 import Signal
    from .io.slow5 import write_blow5

    os.makedirs(outdir, exist_ok=True)
    paths = {k: os.path.join(outdir, f) for k, f in (
        ("genome", "genome.fa"), ("reads", "reads.fasta"),
        ("bam", "reads.bam"), ("blow5", "signals.blow5"))}
    reads = sorted(reads, key=lambda r: r.pos)
    with open(paths["genome"], "w") as f:
        f.write(f">{contig}\n{genome}\n")
    with open(paths["reads"], "w") as f:
        f.writelines(f">{r.qname}\n{r.read_seq}\n" for r in reads)

    class _Rec:
        def __init__(self, r):
            self.qname, self.flag, self.tid, self.pos = r.qname, r.flag, 0, \
                r.pos
            self.mapq, self.cigar, self.seq = 60, r.cigar, r.bam_seq

    write_bam(paths["bam"], [(contig, len(genome))], map(_Rec, reads))
    write_blow5(paths["blow5"], (
        Signal(raw=simulate_signal(rng, r.read_seq, model),
               digitisation=DIGITISATION, offset=OFFSET, range=RANGE,
               sample_rate=SAMPLE_RATE, read_id=r.qname) for r in reads),
        rec_press=rec_press)
    return paths


def genome_mapped(outdir: str, seed: int, n_reads: int = 1024,
                  genome_len: int = 1_000_000, median_len: int = 4000,
                  extra_lengths: tuple = (120_000,)) -> dict:
    """The real-size dataset: a random genome, ``n_reads`` log-normal
    reads (median ``median_len``, 1-30 kb) plus one read of each
    ``extra_lengths``; returns write_dataset's paths plus the reads."""
    from .models import builtin_model

    rng = np.random.default_rng(seed)
    genome = random_genome(rng, genome_len)
    lengths = list(read_lengths(rng, n_reads, median_len)) + list(
        extra_lengths)
    reads = [mapped_read(rng, genome, f"sim{i:05d}", int(n))
             for i, n in enumerate(lengths)]
    paths = write_dataset(outdir, genome, reads,
                          builtin_model("dna_r9_nucleotide"), rng)
    paths["reads_list"] = reads
    paths["genome_seq"] = genome
    return paths


def read_events(rng, seq: str, model):
    """A simulated read's events and MoM scaling (native host detector
    when available, else the NumPy oracle): (event_means, ranks,
    scaling)."""
    from . import native
    from .io.fast5 import Signal

    sig = Signal(raw=simulate_signal(rng, seq, model),
                 digitisation=DIGITISATION, offset=OFFSET, range=RANGE,
                 sample_rate=SAMPLE_RATE, read_id="")
    ranks = model.kmer_ranks(seq).astype(np.int32)
    if native.available():
        et = native.detect_events(sig.to_pa())
        sc = native.mom_scalings(et.mean, ranks, model.level_mean)
    else:
        from .ops.abea_ref import estimate_scalings_using_mom
        from .ops.events_ref import detect_events

        et = detect_events(sig.to_pa())
        sc = estimate_scalings_using_mom(seq, model, et.mean)
    return np.ascontiguousarray(et.mean, np.float32), ranks, sc
