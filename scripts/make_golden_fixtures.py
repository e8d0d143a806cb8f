#!/usr/bin/env python3
"""Generate the vendored synthetic golden end-to-end dataset + fixtures.

The ecoli_2kb_region fixtures pin every STAGE, but the genome-true
end-to-end oracles (meth.exp LLRs against draft.fa —
/root/reference/scripts/test.sh:59-103) cannot be reproduced offline:
the draft genome is stripped from the vendored test tree.  This script
builds the closest achievable substitute: a small synthetic genome and
reads exercising the alignment shapes the self-alignment datasets lack
(reverse strands, insertions, deletions, soft clips, mismatches), with
raw signals SIMULATED from the R9 pore model, and golden outputs
computed OFFLINE once and vendored:

- ``meth.exp``     — call-methylation TSV through the pure-NumPy oracle
  stack end to end: ops/events_ref -> ops/abea_ref (align + postalign +
  recalibrate) -> pipeline/methylation.call_methylation_for_read
  (ops/hmm_ref forward scorer).  No device code.
- ``eventalign.exp.gz`` + ``eventalign.summary.exp`` — eventalign TSV +
  summary with the same oracle-derived read state (events, scalings,
  b2e maps all from ops/*_ref.py); the per-chunk Viterbi DP runs via
  native.viterbi_chunk, the loop-faithful C++ reference port that
  tests/test_viterbi.py pins bit-exactly to the NumPy oracle
  (ops/hmm_ref.profile_hmm_viterbi).

Inputs (genome.fa, reads.fasta, reads.bam, signals.blow5) and outputs
are vendored under tests/data/golden/ so the PRODUCTION device pipeline
is gated against genome-true LLR semantics in CI and the default suite
(tests/test_golden_e2e.py) with the reference's float tolerance
(|x - t| <= 0.1|t| + 0.02, <= 5 %% deviant rows — scripts/test.awk:7-13).

The vendored files were made with an earlier per-kmer version of the
signal simulator; f5c_tpu/sim.py draws its random numbers in another
order, so a rerun writes a different (equally valid) dataset.

Usage: python scripts/make_golden_fixtures.py [outdir]
(default outdir: tests/data/golden)
"""

import gzip
import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEED = 20260820


def build_dataset(outdir: str):
    """Genome + 6 reads covering forward/reverse x perfect/indel/
    mismatch alignments; BAM + readable FASTA + BLOW5 signals."""
    from f5c_tpu.io.bam import write_bam
    from f5c_tpu.io.fast5 import Signal
    from f5c_tpu.io.slow5 import write_blow5
    from f5c_tpu.models import builtin_model
    from f5c_tpu.sim import (DIGITISATION, OFFSET, RANGE, SAMPLE_RATE,
                             mutate, revcomp, simulate_signal)

    rng = np.random.default_rng(SEED)
    model = builtin_model("dna_r9_nucleotide")
    genome = "".join(rng.choice(list("ACGT"), 3200))

    reads = []      # (qname, read_seq, flag, pos, cigar, bam_seq)

    def fwd(qname, pos, n):
        seg = genome[pos:pos + n]
        reads.append((qname, seg, 0, pos, [(0, n)], seg))

    # r0/r5: perfect forward; r4: forward with ~1% mismatches
    fwd("gr0", 0, 1200)
    fwd("gr5", 400, 1000)
    seg = genome[1800:3100]
    read4 = mutate(rng, seg, 0.01)
    reads.append(("gr4", read4, 0, 1800, [(0, len(seg))], read4))

    # r1: perfect reverse: basecalled read is the revcomp of the
    # reference window; BAM stores the ref-oriented sequence (flag 16)
    seg = genome[700:1900]
    reads.append(("gr1", revcomp(seg), 16, 700, [(0, len(seg))], seg))

    # r2: forward with soft clips + insertion + deletion
    clip = "".join(rng.choice(list("ACGT"), 40))
    ins = "".join(rng.choice(list("ACGT"), 25))
    p = 1200
    m1, dl, m2 = 500, 35, 400
    read2 = (clip + genome[p:p + m1] + ins
             + genome[p + m1 + dl:p + m1 + dl + m2] + clip)
    cig2 = [(4, 40), (0, m1), (1, 25), (2, dl), (0, m2), (4, 40)]
    reads.append(("gr2", read2, 0, p, cig2, read2))

    # r3: reverse with an insertion (ref-oriented construction, then
    # the basecalled read is the revcomp)
    p = 300
    m1, m2 = 600, 500
    ins3 = "".join(rng.choice(list("ACGT"), 30))
    ref_oriented = genome[p:p + m1] + ins3 + genome[p + m1:p + m1 + m2]
    cig3 = [(0, m1), (1, 30), (0, m2)]
    reads.append(("gr3", revcomp(ref_oriented), 16, p, cig3,
                  ref_oriented))

    # coordinate order: fixtures are emitted in BAM iteration order, so
    # the vendored BAM and the .exp files must agree on it
    reads.sort(key=lambda t: t[3])

    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "genome.fa"), "w") as g:
        g.write(f">golden_ctg\n{genome}\n")
    with open(os.path.join(outdir, "reads.fasta"), "w") as f:
        for qname, read_seq, *_ in reads:
            f.write(f">{qname}\n{read_seq}\n")

    class Rec:
        pass

    recs = []
    for i, (qname, read_seq, flag, pos, cigar, bam_seq) in enumerate(reads):
        rec = Rec()
        rec.qname = qname
        rec.flag = flag
        rec.tid = 0
        rec.pos = pos
        rec.mapq = 60
        rec.cigar = cigar
        rec.seq = bam_seq
        recs.append(rec)
    write_bam(os.path.join(outdir, "reads.bam"),
              [("golden_ctg", len(genome))], recs)

    sigs = []
    for qname, read_seq, *_ in reads:
        raw = simulate_signal(rng, read_seq, model)
        sigs.append(Signal(raw=raw, digitisation=DIGITISATION,
                           offset=OFFSET, range=RANGE,
                           sample_rate=SAMPLE_RATE, read_id=qname))
    write_blow5(os.path.join(outdir, "signals.blow5"), sigs,
                rec_press="zstd")
    return genome, reads, sigs, model


class _OracleRead:
    """Minimal read facade for the eventalign engine + emitters."""

    def __init__(self, qname, seq, pos, cigar, is_reverse, st, sig):
        self.qname = qname
        self.seq = seq
        self.pos = pos
        self.cigar = cigar
        self.is_reverse = is_reverse
        et = st["events"]
        self.event_means = np.ascontiguousarray(et.mean, np.float32)
        self.event_stdvs = np.ascontiguousarray(et.stdv, np.float32)
        self.event_starts = np.ascontiguousarray(et.start, np.int64)
        self.event_lengths = np.ascontiguousarray(et.length, np.float32)
        self.scaling = st["scaling"]
        self.b2e_start = st["b2e_start"]
        self.b2e_stop = st["b2e_stop"]
        self.events_per_base = st["events_per_base"]
        self.sample_rate = sig.sample_rate
        self.raw_pa = sig.to_pa()


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "tests", "data", "golden")
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    genome, reads, sigs, model = build_dataset(outdir)

    from f5c_tpu.models import builtin_model
    from f5c_tpu.oracle import oracle_meth_rows, oracle_read_state
    from f5c_tpu.pipeline.eventalign import (EventalignEngine, emit_tsv,
                                             summarize_alignment,
                                             summary_line, summary_header,
                                             tsv_header)

    cpg = builtin_model("dna_r9_cpg")

    states = []
    for (qname, read_seq, flag, pos, cigar, bam_seq), sig in zip(reads,
                                                                 sigs):
        st = oracle_read_state(sig.to_pa(), read_seq, model)
        assert st is not None, f"{qname}: oracle QC rejected the read"
        states.append(st)
    print(f"[golden] all {len(states)} reads pass the oracle QC chain")

    # ---- meth.exp: the pure-NumPy oracle end to end ----
    meth = io.StringIO()
    meth.write("chromosome\tstart\tend\tread_name\tlog_lik_ratio\t"
               "log_lik_methylated\tlog_lik_unmethylated\t"
               "num_calling_strands\tnum_cpgs\tsequence\n")
    for (qname, read_seq, flag, pos, cigar, bam_seq), st in zip(reads,
                                                                states):
        ref_span = sum(ln for op, ln in cigar if op in (0, 2))
        meth.write(oracle_meth_rows(
            "golden_ctg", genome[pos:pos + ref_span], qname, read_seq, pos,
            cigar, bool(flag & 16), st, cpg, 1))
    with open(os.path.join(outdir, "meth.exp"), "w") as f:
        f.write(meth.getvalue())
    n_meth = meth.getvalue().count("\n") - 1
    print(f"[golden] meth.exp: {n_meth} site rows")
    assert n_meth > 20, "too few CpG sites scored — dataset too easy"

    # ---- eventalign.exp + summary: oracle state + python lockstep ----
    # cursor with host-round chunk DP (native.viterbi_chunk; bit-pinned
    # to ops/hmm_ref.profile_hmm_viterbi by tests/test_viterbi.py)
    os.environ["F5C_TPU_EA_ENGINE"] = "python"
    engine = EventalignEngine(model)
    oreads, segs = [], []
    for (qname, read_seq, flag, pos, cigar, bam_seq), st, sig in zip(
            reads, states, sigs):
        ref_span = sum(ln for op, ln in cigar if op in (0, 2))
        oreads.append(_OracleRead(qname, read_seq, pos, cigar,
                                  bool(flag & 16), st, sig))
        segs.append(genome[pos:pos + ref_span])
    recs_map = engine.realign_batch(oreads, segs)

    ea = io.StringIO()
    ea.write(tsv_header())
    summ = io.StringIO()
    summ.write(summary_header())
    for i, r in enumerate(oreads):
        recs = recs_map[id(r)]
        dis = recs.ref_disamb
        ea.write(emit_tsv(recs, r, model, "golden_ctg", dis,
                          recs.ref_offset, i))
        s = summarize_alignment(recs, r, nm=0)
        summ.write(summary_line(i, r.qname, "signals.blow5", False, s,
                                r.sample_rate, r.scaling))
    with gzip.open(os.path.join(outdir, "eventalign.exp.gz"), "wt") as f:
        f.write(ea.getvalue())
    with open(os.path.join(outdir, "eventalign.summary.exp"), "w") as f:
        f.write(summ.getvalue())
    print(f"[golden] eventalign.exp.gz: {ea.getvalue().count(chr(10)) - 1}"
          f" rows; summary: {len(oreads)} reads")
    print(f"[golden] wrote fixtures to {outdir}")


if __name__ == "__main__":
    main()
