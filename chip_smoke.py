#!/usr/bin/env python3
"""Smoke test of f5c-tpu on an NVIDIA GPU: the main path end to end.

    python chip_smoke.py [--seed N] [--chips 4]

One process drives the card.  Phases (any failure exits non-zero and
prints no result line):

1. setup: refuse to run without a GPU; print the card's name and power
   limit; check that this process alone holds the card; build the native
   host library and the CUDA ABEA kernel (build seconds printed).
2. generate the real-size dataset from ``--seed`` (f5c_tpu/sim.py): a
   1 Mb random genome, 1,024 log-normal reads (median ~4 kb, 1-30 kb)
   plus one 120 kb read, both strands, ~1% substitutions, indels and
   soft clips, R9.4 signal at 4 kHz in BLOW5.
3. kernel parity at real widths: the ABEA kernel vs ops/abea_ref on 16
   reads from 1 to 30 kb plus the 120 kb read (pairs must be equal); the
   XLA route on the GPU vs the same oracle (reported); the kernel's
   ``memory_analysis()``.
4. golden end to end through the CLI on tests/data/golden/:
   call-methylation and eventalign vs the vendored fixtures, 0 deviant
   rows (tests/test_golden_e2e.py's comparison).
5. real size through the CLI at f5c's defaults (-K 512 -B 2M): index,
   call-methylation and eventalign, cold and warm walls, reads/s,
   bases/s, stage seconds, peak device memory, the engines chosen; a
   32-read subset vs the NumPy oracle stack (<= 5% deviant rows); host
   vs device event detection timed once.

The last line is ``{"ok": true, "device": {...}}``.

``--chips 4`` runs only the multi-device path: call-methylation and
eventalign on the generated set dealt over 4 cards vs the same run on
one card in this process, byte for byte (f5c_tpu/parallel/mesh_check.py).
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def log(*a):
    print(*a, flush=True)


def nvidia_smi(*query):
    return subprocess.run(["nvidia-smi", *query], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def check_sole_process():
    """Only this process may hold the card (a JAX process reserves most
    of its memory)."""
    apps = nvidia_smi("--query-compute-apps=pid,used_memory",
                      "--format=csv,noheader")
    log(f"[setup] compute apps on the card: {apps or '(none visible)'}")
    pids = {int(ln.split(",")[0]) for ln in apps.splitlines() if ln.strip()}
    others = pids - {os.getpid()}
    # inside a PID namespace the card may report host PIDs: then only
    # a count above one means a second process
    if others and (os.getpid() in pids or len(pids) > 1):
        raise RuntimeError(f"other processes hold the card: {others}")


def cli(argv):
    """Run the CLI in this process; returns (exit code, stderr text)."""
    from f5c_tpu.cli import main

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    if rc:
        raise RuntimeError(f"f5c-tpu {' '.join(argv[:1])} exited {rc}:\n"
                           + err.getvalue()[-3000:])
    return err.getvalue()


def report_lines(stderr_text):
    return [ln for ln in stderr_text.splitlines()
            if "stage seconds" in ln or "engines:" in ln
            or "candidate reads" in ln or "failed:" in ln]


def read_signals(blow5, names):
    from f5c_tpu.io.slow5 import Slow5File

    f = Slow5File(blow5)
    try:
        return {n: f.get(n) for n in names}
    finally:
        f.close()


# ---- phase 3: kernel parity -------------------------------------------------

def phase_parity(ds, model):
    import numpy as np

    from f5c_tpu import native
    from f5c_tpu.ops import abea, abea_cuda, abea_ref

    reads = sorted(ds["reads_list"], key=lambda r: len(r.read_seq))
    short = [r for r in reads if len(r.read_seq) <= 30_000]
    pick = [short[int(i)] for i in np.linspace(0, len(short) - 1, 16)]
    pick.append(reads[-1])
    assert len(reads[-1].read_seq) >= 100_000
    sigs = read_signals(ds["blow5"], [r.qname for r in pick])
    evs, rks, scs = [], [], []
    for r in pick:
        et = native.detect_events(sigs[r.qname].to_pa())
        rk = native.kmer_ranks(r.read_seq, model.k)
        evs.append(np.ascontiguousarray(et.mean, np.float32))
        rks.append(rk)
        scs.append(native.mom_scalings(et.mean, rk, model.level_mean))
    lens = [len(r.read_seq) for r in pick]
    log(f"[parity] {len(pick)} reads, {min(lens)}-{max(lens)} bases, "
        f"{sum(e.shape[0] for e in evs)} events")
    t0 = time.perf_counter()
    cu = abea.align_reads(abea_cuda.abea_align_cuda, evs, rks, scs, model)
    t_cu = time.perf_counter() - t0
    n16 = 16
    t0 = time.perf_counter()
    xl = abea.align_reads(abea.abea_align_xla, evs[:n16], rks[:n16],
                          scs[:n16], model)
    t_xl = time.perf_counter() - t0
    n_eq = n_xl = 0
    t0 = time.perf_counter()
    for i, r in enumerate(pick):
        ref = abea_ref.align(r.read_seq, evs[i], model, scs[i])
        if ref.failed:
            raise AssertionError(f"{r.qname}: the oracle rejected the read")
        if cu[i] is None or not np.array_equal(cu[i], ref.pairs):
            raise AssertionError(f"{r.qname} ({lens[i]} bases): kernel "
                                 "pairs differ from abea_ref")
        n_eq += 1
        if i < n16 and xl[i] is not None and np.array_equal(xl[i],
                                                             ref.pairs):
            n_xl += 1
    log(f"[parity] ABEA kernel == abea_ref bit for bit: {n_eq}/{len(pick)} "
        f"reads ({t_cu:.2f} s incl. compile; oracle "
        f"{time.perf_counter() - t0:.1f} s)")
    log(f"[parity] XLA route on the GPU == abea_ref bit for bit: "
        f"{n_xl}/{n16} reads ({t_xl:.2f} s incl. compile)")
    # memory analysis of the kernel step at these widths
    import jax.numpy as jnp

    ev_len = np.array([e.shape[0] for e in evs])
    rk_len = np.array([k.shape[0] for k in rks])
    plan = abea.plan_launch(
        np.concatenate([[0], np.cumsum(ev_len)[:-1]]), ev_len,
        np.concatenate([[0], np.cumsum(rk_len)[:-1]]), rk_len,
        [s.scale for s in scs], [s.shift for s in scs])
    args = (jnp.zeros(int(ev_len.sum()), jnp.float32),
            jnp.zeros(int(rk_len.sum()), jnp.int32),
            jnp.asarray(plan.meta_i), jnp.asarray(plan.meta_f),
            jnp.asarray(plan.byte_off), jnp.asarray(model.level_mean),
            jnp.asarray(model.level_stdv), jnp.asarray(model.level_log_stdv))
    mem = abea_cuda.abea_align_cuda.lower(
        *args, **plan.statics).compile().memory_analysis()
    log(f"[parity] ABEA step memory_analysis: {mem}")


# ---- phase 4: golden through the CLI -----------------------------------------

def phase_golden(work):
    import gzip

    from f5c_tpu.oracle import tolerant_compare

    golden = os.path.join(REPO, "tests", "data", "golden")
    d = os.path.join(work, "golden")
    os.makedirs(d)
    for f in ("genome.fa", "reads.fasta", "reads.bam", "signals.blow5"):
        shutil.copy(os.path.join(golden, f), d)
    p = {f: os.path.join(d, f) for f in os.listdir(d)}
    common = ["-b", p["reads.bam"], "-g", p["genome.fa"], "-r",
              p["reads.fasta"], "--slow5", p["signals.blow5"],
              "--min-mapq", "0"]
    cli(["index", p["reads.fasta"], "--slow5", p["signals.blow5"]])
    meth = os.path.join(d, "meth.tsv")
    cli(["call-methylation", *common, "--meth-out-version", "1",
         "-o", meth])
    with open(meth) as a, open(os.path.join(golden, "meth.exp")) as b:
        bad, n = tolerant_compare(a.read(), b.read(), {4, 5, 6})
    log(f"[golden] call-methylation vs meth.exp: {bad} deviant of {n} rows")
    ea = os.path.join(d, "ea.tsv")
    summ = os.path.join(d, "summary.tsv")
    cli(["eventalign", *common, "--summary", summ, "-o", ea])
    with open(ea) as a, gzip.open(os.path.join(golden, "eventalign.exp.gz"),
                                  "rt") as b:
        bad, n = tolerant_compare(a.read(), b.read(),
                                  {6, 7, 8, 10, 11, 12})
    log(f"[golden] eventalign vs eventalign.exp.gz: {bad} deviant of {n} "
        "rows")

    def norm(text):   # the summary's signal path column is machine-local
        rows = []
        for ln in text.rstrip("\n").split("\n"):
            c = ln.split("\t")
            if len(c) > 2:
                c[2] = os.path.basename(c[2])
            rows.append("\t".join(c))
        return "\n".join(rows) + "\n"

    with open(summ) as a, open(os.path.join(
            golden, "eventalign.summary.exp")) as b:
        bad, n = tolerant_compare(norm(a.read()), norm(b.read()),
                                  {9, 10, 11, 12, 13})
    log(f"[golden] eventalign summary vs eventalign.summary.exp: {bad} "
        f"deviant of {n} rows")


# ---- phase 5: real size ------------------------------------------------------

def phase_real(ds, model, work):
    import jax
    import numpy as np

    reads = ds["reads_list"]
    n_reads = len(reads)
    n_bases = sum(len(r.read_seq) for r in reads)
    common = ["-b", ds["bam"], "-g", ds["genome"], "-r", ds["reads"],
              "--slow5", ds["blow5"], "-K", "512", "-B", "2M"]
    t0 = time.perf_counter()
    cli(["index", ds["reads"], "--slow5", ds["blow5"]])
    log(f"[real] index: {time.perf_counter() - t0:.3f} s")
    outs = {}
    for tool, extra in (("call-methylation", []),
                        ("eventalign", ["--summary",
                                        os.path.join(work, "summary.tsv")])):
        for run in ("cold", "warm"):
            out = os.path.join(work, f"{tool}.{run}.tsv")
            t0 = time.perf_counter()
            err = cli([tool, *common, *extra, "-o", out])
            wall = time.perf_counter() - t0
            outs[tool] = out
            log(f"[real] {tool} {run}: wall {wall:.3f} s, "
                f"{n_reads / wall:.2f} reads/s, {n_bases / wall:.0f} "
                f"bases/s ({n_reads} reads, {n_bases} bases)")
            for ln in report_lines(err):
                log(f"[real]   {ln}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[real] peak device memory: "
        f"{stats.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB "
        f"(of {stats.get('bytes_limit', 0) / 2**30:.1f} GiB)")
    phase_oracle_subset(ds, model, outs["call-methylation"])
    phase_events_timing(ds, reads)


def phase_oracle_subset(ds, model, meth_tsv):
    """32 reads through the NumPy oracle stack vs the CLI's rows."""
    import numpy as np

    from f5c_tpu.models import builtin_model
    from f5c_tpu.oracle import oracle_meth_rows, oracle_read_state

    rng = np.random.default_rng(0)
    cands = [r for r in ds["reads_list"] if len(r.read_seq) <= 6000]
    sub = [cands[int(i)] for i in rng.choice(len(cands), 32, replace=False)]
    names = {r.qname for r in sub}
    sigs = read_signals(ds["blow5"], names)
    cpg = builtin_model("dna_r9_cpg")
    genome = ds["genome_seq"]
    t0 = time.perf_counter()
    truth = []
    n_rejected = 0
    for r in sub:
        st = oracle_read_state(sigs[r.qname].to_pa(), r.read_seq, model)
        if st is None:
            n_rejected += 1
            continue
        truth.append(oracle_meth_rows(
            "sim_ctg", genome[r.pos:r.pos + r.ref_span], r.qname,
            r.read_seq, r.pos, r.cigar, r.is_reverse, st, cpg, 2))
    truth_rows = {}
    for ln in "".join(truth).splitlines():
        c = ln.split("\t")
        truth_rows[(c[4], c[2], c[1])] = c
    ours_rows = {}
    with open(meth_tsv) as f:
        for ln in f:
            c = ln.rstrip("\n").split("\t")
            if c[4] in names:
                ours_rows[(c[4], c[2], c[1])] = c
    bad = 0
    for key, t in truth_rows.items():
        o = ours_rows.get(key)
        ok = o is not None and len(o) == len(t) and all(
            (abs(float(x) - float(y)) <= 0.1 * abs(float(y)) + 0.02)
            if i in (5, 6, 7) else x == y for i, (x, y) in enumerate(zip(o, t)))
        bad += not ok
    extra = len(set(ours_rows) - set(truth_rows))
    n = max(len(truth_rows), 1)
    log(f"[oracle] 32-read subset ({n_rejected} rejected by the oracle QC): "
        f"{bad} deviant of {len(truth_rows)} oracle rows, {extra} rows "
        f"only in ours ({time.perf_counter() - t0:.1f} s)")
    if (bad + extra) / n > 0.05 or len(truth_rows) < 100:
        raise AssertionError("more than 5% of the subset's rows deviate "
                             "from the oracle stack")


def phase_events_timing(ds, reads):
    """Host (native) vs device (ops/events_device.py) event detection on
    the same 128 reads, results on the host; the device call is timed
    warm (one batch, so one compiled shape)."""
    import jax

    from f5c_tpu import native
    from f5c_tpu.ops.events_device import detect_events_batch

    sub = sorted(reads, key=lambda r: r.qname)[:128]
    sigs = read_signals(ds["blow5"], [r.qname for r in sub])
    pas = [sigs[r.qname].to_pa() for r in sub]
    t0 = time.perf_counter()
    detect_events_batch(pas)
    t_cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    detect_events_batch(pas)
    t_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.detect_events_many(pas)
    t_host = time.perf_counter() - t0
    n = sum(p.shape[0] for p in pas)
    log(f"[events] {len(pas)} reads, {n} samples: host (native, one "
        f"thread) {t_host:.3f} s; device ({jax.devices()[0].device_kind}"
        f", one batch, incl. D2H) {t_dev:.3f} s warm, {t_cold:.3f} s "
        "with compile")


def run_multichip(ds, n):
    from f5c_tpu.parallel.mesh_check import run_mesh_parity

    res = run_mesh_parity(os.path.dirname(ds["bam"]),
                          opt_kw=dict(batch_reads=512,
                                      batch_bases=2_000_000), log=log)
    log(f"[chips={n}] walls: 1 card {res['single']}, {n} cards "
        f"{res['sharded']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX backend is {jax.default_backend()!r}, "
              "not a GPU", file=sys.stderr)
        return 1
    devs = jax.devices()
    if len(devs) < args.chips:
        print(f"chip_smoke: {args.chips} GPUs needed, {len(devs)} found",
              file=sys.stderr)
        return 1
    log(f"[setup] card: {nvidia_smi('--query-gpu=name,power.limit', '--format=csv,noheader')}")
    log(f"[setup] jax {jax.__version__}: {len(devs)} x "
        f"{devs[0].device_kind}")

    from f5c_tpu import native, sim
    from f5c_tpu.models import builtin_model
    from f5c_tpu.ops import abea_cuda

    if not native.available():
        raise RuntimeError("native host library unavailable")
    log(f"[setup] CUDA ABEA kernel built and loaded in "
        f"{abea_cuda.load():.2f} s")
    check_sole_process()

    work = tempfile.mkdtemp(prefix="f5c_smoke_")
    try:
        t0 = time.perf_counter()
        ds = sim.genome_mapped(os.path.join(work, "sim"), seed=args.seed)
        log(f"[data] generated {len(ds['reads_list'])} reads, "
            f"{sum(len(r.read_seq) for r in ds['reads_list'])} bases "
            f"(seed {args.seed}) in {time.perf_counter() - t0:.1f} s")
        if args.chips > 1:
            run_multichip(ds, args.chips)
        else:
            model = builtin_model("dna_r9_nucleotide")
            phase_parity(ds, model)
            phase_golden(work)
            phase_real(ds, model, work)
            check_sole_process()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
