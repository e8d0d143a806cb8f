"""f5c-tpu command line: index, call-methylation, eventalign, meth-freq,
freq-merge, resquiggle.

Mirrors the reference CLI surface (f5c {index,call-methylation,eventalign,
meth-freq,freq-merge,resquiggle}, src/main.c:84-101) with the same core
flags; accelerator flags select the JAX device instead of CUDA knobs.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

__version__ = "0.1.0"


def _add_common_meth_args(p):
    p.add_argument("-b", "--bam", required=True, help="sorted BAM file")
    p.add_argument("-g", "--genome", required=True, help="reference genome FASTA")
    p.add_argument("-r", "--reads", required=True, help="reads FASTA/FASTQ")
    p.add_argument("-t", "--threads", type=int, default=None,
                   help="host worker processes")
    p.add_argument("-K", "--batchsize", type=int, default=None,
                   help="max reads per batch [512]")
    p.add_argument("-B", "--max-bases", type=_kmg, default=None,
                   help="max bases per batch (K/M/G suffixes ok) [5M]")
    p.add_argument("-x", "--profile", default=None,
                   help="parameter preset (laptop/desktop/hpc/hpc-gpu/... or "
                        "a file of 7 numbers), applied before other flags")
    p.add_argument("-w", "--window", default=None,
                   help="genomic region chr:start-end or a .bed file")
    p.add_argument("--ultra-thresh", type=_kmg, default=100_000,
                   help="threshold for ultra-long reads")
    p.add_argument("--skip-ultra", default=None, metavar="FILE",
                   help="skip ultra-long reads, writing them to FILE (BAM) "
                        "for a second pass")
    p.add_argument("--min-mapq", type=int, default=20)
    p.add_argument("--slow5", help="SLOW5/BLOW5 signal file (instead of "
                   "FAST5 via the readdb index)")
    p.add_argument("--secondary", choices=["yes", "no"], default="no")
    p.add_argument("--rna", action="store_true", help="direct RNA data")
    p.add_argument("--pore", choices=["r9", "r10", "rna004"], default="r9")
    p.add_argument("--kmer-model", help="custom nucleotide model file")
    p.add_argument("--meth-model", help="custom methylation model file")
    p.add_argument("--min-recalib-events", type=int, default=200,
                   help="min events to attempt recalibration")
    p.add_argument("--device", choices=["auto", "cpu"], default="auto",
                   help="'cpu' forces JAX onto host CPU")
    p.add_argument("--events-engine", choices=["auto", "host", "device"],
                   default="auto",
                   help="event-detection engine: host C++ or the batched "
                        "on-device detector; auto takes the host engine "
                        "when the native library is built")
    p.add_argument("-o", "--output", default="-", help="output file")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process only reads with read_idx %% N == I "
                        "(multi-host data parallelism; merge outputs "
                        "with cat / freq-merge)")
    p.add_argument("--dist", action="store_true",
                   help="multi-process mode via jax.distributed: each "
                        "process takes its read shard, writes "
                        "<output>.partN, and process 0 merges to the "
                        "exact single-process output (requires -o FILE)")
    p.add_argument("--dist-coordinator", default=None, metavar="HOST:PORT",
                   help="coordination service address for manual --dist "
                        "launches (auto-detected under SLURM)")
    p.add_argument("--dist-rank", type=int, default=None,
                   help="this process's rank for manual --dist launches")
    p.add_argument("--dist-nprocs", type=int, default=None,
                   help="total process count for manual --dist launches")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a JAX profiler trace of the run to DIR "
                        "(view with TensorBoard/XProf)")
    p.add_argument("--print-events", action="store_true",
                   help="dump the event table (debug oracle)")
    p.add_argument("--print-banded-aln", action="store_true",
                   help="dump ABEA aligned pairs (debug oracle)")
    p.add_argument("--print-raw", action="store_true",
                   help="print the raw ADC signal of each read at load "
                        "(debug; forces single-process BAM-ordered loads)")
    p.add_argument("--skip-unreadable", choices=["yes", "no"],
                   default="yes",
                   help="skip unreadable signal records with a counter "
                        "(yes) or abort (no)")
    p.add_argument("--write-dump", default=None, metavar="FILE",
                   help="cache raw signals to FILE while loading "
                        "(reference binary dump format)")
    p.add_argument("--read-dump", default=None, metavar="FILE",
                   help="load raw signals from a --write-dump cache "
                        "instead of FAST5/SLOW5 (same BAM + filters)")
    p.add_argument("--debug-break", type=int, default=-1, metavar="N",
                   help="stop after processing N batches (debug)")
    p.add_argument("--profile-cpu", choices=["yes", "no"], default="no",
                   help="print the per-component stage breakdown at exit "
                        "(stage timing is always on; this adds "
                        "host/transfer/dispatch detail)")
    p.add_argument("--print-scaling", action="store_true",
                   help="dump calibrated scalings (debug oracle)")
    p.add_argument("--verbose", type=int, default=0)
    _add_cuda_compat_args(p)


def _add_cuda_compat_args(p, full=True):
    """Accept the reference's CUDA tuning knobs (meth_main.c:76-84) so
    f5c command lines are drop-in; they have no effect on the JAX
    backend — a warning points at the equivalents here (the
    reference's non-CUDA build likewise accepts them, warning only for
    --disable-cuda, meth_main.c:313)."""
    g = p.add_argument_group("CUDA compatibility (accepted, no effect)")
    g.add_argument("--disable-cuda", choices=["yes", "no"], default=None,
                   help="no effect (use --device cpu to force host JAX)")
    g.add_argument("--cuda-dev-id", default=None, help=argparse.SUPPRESS)
    g.add_argument("--cuda-mem-frac", default=None, help=argparse.SUPPRESS)
    if full:
        g.add_argument("--cuda-block-size", default=None,
                       help=argparse.SUPPRESS)
        g.add_argument("--cuda-max-lf", default=None, help=argparse.SUPPRESS)
        g.add_argument("--cuda-avg-epk", default=None, help=argparse.SUPPRESS)
        g.add_argument("--cuda-max-epk", default=None, help=argparse.SUPPRESS)


def _warn_cuda_compat(args):
    names = ("disable_cuda", "cuda_dev_id", "cuda_mem_frac",
             "cuda_block_size", "cuda_max_lf", "cuda_avg_epk",
             "cuda_max_epk")
    given = [n.replace("_", "-") for n in names
             if getattr(args, n, None) is not None]
    if given:
        print(f"WARNING: --{', --'.join(given)}: CUDA knobs have no "
              "effect here (batching is tuned via -K/-B, "
              "F5C_TPU_WAVE and F5C_TPU_TRACE_BYTES; see USAGE.md)",
              file=sys.stderr)


def _kmg(s: str) -> int:
    mult = {"k": 10**3, "m": 10**6, "g": 10**9}
    if s and s[-1].lower() in mult:
        return int(float(s[:-1]) * mult[s[-1].lower()])
    return int(s)


def _make_pipeline(args, meth_out_version=2):
    import os

    if args.device == "cpu":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from .pipeline.runner import Options, Pipeline

    opt = Options(
        min_mapq=args.min_mapq,
        keep_secondary=args.secondary == "yes",
        meth_out_version=meth_out_version,
        rna=args.rna,
        pore=args.pore,
        kmer_model_path=args.kmer_model,
        meth_model_path=args.meth_model,
        min_num_events_to_rescale=args.min_recalib_events,
        device=args.device,
        slow5_path=getattr(args, "slow5", None),
        verbose=args.verbose,
        events_engine=getattr(args, "events_engine", "auto"),
    )
    if getattr(args, "profile", None):
        from .profiles import apply_profile

        apply_profile(opt, args.profile)
    # explicit flags override the profile (profiles.c: -x applied first)
    if args.batchsize is not None:
        opt.batch_reads = args.batchsize
    if args.max_bases is not None:
        opt.batch_bases = args.max_bases
    if args.threads:
        opt.num_proc = args.threads
    opt.region_str = getattr(args, "window", None)
    opt.print_events = getattr(args, "print_events", False)
    opt.print_raw = getattr(args, "print_raw", False)
    opt.skip_unreadable = getattr(args, "skip_unreadable", "yes") != "no"
    opt.debug_break = getattr(args, "debug_break", -1)
    opt.write_dump = getattr(args, "write_dump", None)
    opt.read_dump = getattr(args, "read_dump", None)
    opt.profile_detail = getattr(args, "profile_cpu", "no") == "yes"
    opt.print_banded_aln = getattr(args, "print_banded_aln", False)
    opt.print_scaling = getattr(args, "print_scaling", False)
    shard = getattr(args, "shard", None)
    if shard:
        i, n = shard.split("/")
        opt.shard_index, opt.shard_count = int(i), int(n)
    opt.dist_markers = getattr(args, "dist", False)
    opt.ultra_thresh = getattr(args, "ultra_thresh", 100_000)
    opt.skip_ultra = getattr(args, "skip_ultra", None)
    return Pipeline(args.bam, args.genome, args.reads, opt)


def _out_fh(spec):
    return sys.stdout if spec in ("-", None) else open(spec, "w")


def _dist_fail_note(dist_rank):
    """A failed --dist rank must NOT merge partial parts; peers are
    released when this process dies (the coordination service fails
    their barrier on missing heartbeats / the 1 h timeout)."""
    if dist_rank is not None:
        print(f"[f5c-tpu] rank {dist_rank} failed before the output "
              "barrier; part files are left unmerged and peer ranks "
              "will error out of the barrier.", file=sys.stderr)


def _maybe_profile(args):
    """jax profiler trace context for --profile-dir (the analogue of the
    reference's per-stage/CUDA-kernel timers, meth_main.c:749-796)."""
    import contextlib

    d = getattr(args, "profile_dir", None)
    if not d:
        return contextlib.nullcontext()
    import jax

    return jax.profiler.trace(d)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    ap = argparse.ArgumentParser(
        prog="f5c-tpu",
        description="nanopore signal analysis on an NVIDIA GPU "
                    "(index / call-methylation / eventalign / resquiggle)")
    ap.add_argument("--version", action="version",
                    version=f"f5c-tpu {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="build read index (readdb)")
    p.add_argument("reads", help="reads FASTA/FASTQ")
    p.add_argument("-d", "--directory", action="append", default=[],
                   help="FAST5 directory (repeatable)")
    p.add_argument("--slow5", help="SLOW5/BLOW5 signal file")
    p.add_argument("-s", "--summary", action="append", default=[],
                   help="basecaller sequencing summary (repeatable; "
                        "avoids the FAST5 scan)")
    p.add_argument("--iop", type=int, default=1,
                   help="parallel FAST5 scan processes")

    p = sub.add_parser("call-methylation", help="CpG methylation calling")
    _add_common_meth_args(p)
    p.add_argument("--meth-out-version", type=int, choices=[1, 2], default=2)

    p = sub.add_parser("eventalign", help="signal-to-reference alignment")
    _add_common_meth_args(p)
    p.add_argument("--summary", help="write per-read summary TSV")
    p.add_argument("--sam", action="store_true")
    p.add_argument("--sam-out-version", type=int, choices=[1, 2], default=2,
                   help="SAM output: 1 = events-as-CIGAR record, 2 = base "
                        "alignment + si/ss/sc/sh tags")
    p.add_argument("--paf", action="store_true")
    p.add_argument("--m6anet", action="store_true")
    p.add_argument("--scale-events", action="store_true")
    p.add_argument("--samples", action="store_true")
    p.add_argument("--signal-index", action="store_true")
    p.add_argument("--collapse-events", action="store_true")
    p.add_argument("--print-read-names", action="store_true")

    p = sub.add_parser("fast5-to-blow5",
                       help="convert FAST5 files to one BLOW5 "
                            "(zlib records + svb-zd signals)")
    p.add_argument("-d", "--directory", action="append", required=True,
                   help="FAST5 directory (repeatable)")
    p.add_argument("-o", "--output", required=True, help="output .blow5")

    p = sub.add_parser("meth-freq", help="per-site methylation frequency")
    p.add_argument("-i", "--input", default="-")
    p.add_argument("-c", "--call-threshold", type=float, default=2.5)
    p.add_argument("-s", "--split-groups", action="store_true")
    p.add_argument("-o", "--output", default="-")

    p = sub.add_parser("freq-merge", help="merge meth-freq outputs")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", default="-")

    p = sub.add_parser("resquiggle", help="signal-to-read alignment")
    p.add_argument("reads", help="reads FASTA/FASTQ")
    p.add_argument("--events-engine", choices=["auto", "host", "device"],
                   default="auto",
                   help="event-detection engine (see call-methylation)")
    p.add_argument("--verbose", type=int, default=0)
    p.add_argument("--fast5-dir", action="append", default=[],
                   help="FAST5 directory (repeatable)")
    p.add_argument("--slow5", help="SLOW5/BLOW5 signal file")
    p.add_argument("--rna", action="store_true")
    p.add_argument("--pore", choices=["r9", "r10", "rna004"], default="r9")
    p.add_argument("--kmer-model")
    p.add_argument("-t", "--threads", type=int, default=None)
    p.add_argument("-K", "--batchsize", type=int, default=512)
    p.add_argument("-B", "--max-bases", type=_kmg, default=None,
                   help="max bases per batch (compat; resquiggle batches "
                        "by read count)")
    p.add_argument("-x", "--profile", default=None,
                   help="parameter preset (see call-methylation -x)")
    p.add_argument("-c", "--paf", action="store_true",
                   help="PAF output with ss string (default TSV)")
    p.add_argument("--device", choices=["auto", "cpu"], default="auto")
    p.add_argument("-o", "--output", default="-")
    _add_cuda_compat_args(p, full=False)

    args = ap.parse_args(argv)
    _warn_cuda_compat(args)
    t0 = time.time()

    # --dist: join the jax.distributed coordination service BEFORE any
    # jax/backend initialisation, retarget outputs at per-process part
    # files, and remember what to merge at the end (SURVEY §2.7).
    dist_rank = dist_nprocs = None
    dist_outputs = []
    if getattr(args, "dist", False):
        if args.output in ("-", None):
            ap.error("--dist requires -o FILE (per-process part files "
                     "are merged into it)")
        if (getattr(args, "print_events", False)
                or getattr(args, "print_banded_aln", False)
                or getattr(args, "print_scaling", False)
                or getattr(args, "print_raw", False)):
            # debug dumps carry no per-read merge markers, so the k-way
            # part merge would drop or misplace them
            ap.error("--dist is incompatible with --print-* debug "
                     "dumps; run them single-process")
        if (getattr(args, "write_dump", None)
                or getattr(args, "read_dump", None)):
            # the raw dump is a single sequential file in full-BAM
            # order: ranks would clobber it on write and mis-assign
            # records on read (each rank sees only its shard)
            ap.error("--dist is incompatible with --write-dump/"
                     "--read-dump; create/use dumps single-process")
        from .parallel import distributed as dist_mod

        dist_rank, dist_nprocs = dist_mod.initialize(
            args.dist_coordinator, args.dist_nprocs, args.dist_rank)
        args.shard = f"{dist_rank}/{dist_nprocs}"
        dist_outputs.append(args.output)
        args.output = dist_mod.part_path(args.output, dist_rank)
        if getattr(args, "summary", None):
            dist_outputs.append(args.summary)
            args.summary = dist_mod.part_path(args.summary, dist_rank)

    if args.cmd == "index":
        from .io.readdb import ReadDB

        db = ReadDB(args.reads)
        db.build(fast5_dirs=args.directory or None, slow5_path=args.slow5,
                 sequencing_summary=args.summary or None, iop=args.iop)
        if args.slow5:
            from .io.slow5 import Slow5File

            Slow5File(args.slow5).close()   # builds <file>.idx
        print(f"[f5c-tpu index] indexed {len(db._fa.entries)} reads "
              f"({len(db._paths or {})} with signal paths) "
              f"in {time.time()-t0:.1f}s", file=sys.stderr)
        return 0

    if args.cmd == "call-methylation":
        pipe = _make_pipeline(args, meth_out_version=args.meth_out_version)
        out = _out_fh(args.output)
        try:
            with _maybe_profile(args):
                pipe.call_methylation(out=out)
        except BaseException:
            _dist_fail_note(dist_rank)
            raise
        if out is not sys.stdout:
            out.close()
        if dist_rank is not None:
            from .parallel import distributed as dist_mod

            dist_mod.finalize(dist_outputs, dist_rank, dist_nprocs)
        return pipe.report()

    if args.cmd == "eventalign":
        from .pipeline.eventalign import run_eventalign

        pipe = _make_pipeline(args)
        out = _out_fh(args.output)
        try:
            with _maybe_profile(args):
                run_eventalign(pipe, args, out=out)
        except BaseException:
            _dist_fail_note(dist_rank)
            raise
        if out is not sys.stdout:
            out.close()
        if dist_rank is not None:
            from .parallel import distributed as dist_mod

            dist_mod.finalize(dist_outputs, dist_rank, dist_nprocs)
        return pipe.report()

    if args.cmd == "fast5-to-blow5":
        import glob as _glob

        from .io.fast5 import Fast5File
        from .io.slow5 import Slow5File, write_blow5

        def signals():
            n = 0
            for d in args.directory:
                for root, _dirs, files in os.walk(d):
                    for fn in sorted(files):
                        if not fn.endswith(".fast5"):
                            continue
                        try:
                            with Fast5File(os.path.join(root, fn)) as f5:
                                for rid in f5.read_ids():
                                    yield f5.get_signal(rid)
                                    n += 1
                        except OSError as e:
                            print(f"[f5c-tpu] skipping {fn}: {e}",
                                  file=sys.stderr)

        write_blow5(args.output, signals())
        Slow5File(args.output).close()   # build the .idx
        n_idx = len(Slow5File(args.output,
                              create_index_if_missing=False).read_ids())
        print(f"[f5c-tpu] wrote {n_idx} reads to {args.output} "
              f"(+.idx) in {time.time()-t0:.1f}s", file=sys.stderr)
        return 0

    if args.cmd == "meth-freq":
        from .pipeline.freq import meth_freq

        fh = sys.stdin if args.input == "-" else open(args.input)
        meth_freq(fh, call_threshold=args.call_threshold,
                  split_groups=args.split_groups, out=_out_fh(args.output))
        return 0

    if args.cmd == "freq-merge":
        from .pipeline.freq import freq_merge

        freq_merge(args.inputs, out=_out_fh(args.output))
        return 0

    if args.cmd == "resquiggle":
        from .pipeline.resquiggle import run_resquiggle

        run_resquiggle(args, out=_out_fh(args.output))
        return 0

    ap.error(f"unknown command {args.cmd}")


if __name__ == "__main__":
    sys.exit(main())
