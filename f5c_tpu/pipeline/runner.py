"""Batch pipeline: load -> process -> output.

The runtime equivalent of the reference's core (init_core/load_db/
process_db/output_db + the 3-stage interleaved pipeline in meth_main):

- **load** (host): BAM iteration with filters, read sequences from the
  readdb index, raw signals from FAST5/BLOW5 via a process pool, event
  detection + MoM scaling per read (CPU-bound, fanned out over workers).
- **process** (device): ABEA over a length-binned padded batch, then the
  batched profile-HMM over all CpG-group windows of the batch.
- **output** (host): TSV emission in BAM order.

Batches overlap: while the device processes batch N, workers load batch
N+1 (the reference's pthread pipeline, here a thread + process pool).
"""

from __future__ import annotations

import collections
import functools
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..constants import (
    ABEA_MAX_GAP_THRESHOLD,
    ABEA_MIN_AVG_LOG_EMISSION,
    AVG_EVENTS_PER_KMER_MAX,
    DEFAULT_BATCH_BASES,
    DEFAULT_BATCH_READS,
    DEFAULT_MIN_MAPQ,
    DEFAULT_ULTRA_THRESH,
    FAILED_ALIGNMENT,
    FAILED_CALIBRATION,
    FAILED_QUALITY_CHK,
    MAX_EVENTS_PER_BASE,
    MIN_CALIBRATION_VAR,
)
from ..io.bam import BamReader
from ..io.fasta import FastaIndex
from ..io.readdb import ReadDB
from ..models import builtin_model, load_model_file


@dataclass
class Options:
    min_mapq: int = DEFAULT_MIN_MAPQ
    keep_secondary: bool = False
    batch_reads: int = DEFAULT_BATCH_READS
    batch_bases: int = DEFAULT_BATCH_BASES
    num_proc: int = max(1, (os.cpu_count() or 8) // 2)
    meth_out_version: int = 2
    rna: bool = False
    pore: str = "r9"
    kmer_model_path: str | None = None
    meth_model_path: str | None = None
    min_num_events_to_rescale: int = 200
    device: str = "auto"     # "auto" | "cpu" — jax platform hint
    # event-detection engine: "host" (native C++, events.c path),
    # "device" (batched JAX detector, ops/events_device.py), or "auto"
    # (see Pipeline._events_engine)
    events_engine: str = "auto"
    verbose: int = 0
    slow5_path: str | None = None   # SLOW5/BLOW5 signal file (over readdb)
    region_str: str | None = None   # -w chr:start-end or .bed file
    ultra_thresh: int = DEFAULT_ULTRA_THRESH
    skip_ultra: str | None = None   # BAM path for deferred ultra-long reads
    print_events: bool = False      # stage-level debug dumps (f5c.c:974)
    print_banded_aln: bool = False  # (f5c.c:989)
    print_scaling: bool = False     # (f5c.c:1008)
    print_raw: bool = False         # raw ADC dump at load (f5cio.c:380)
    # binary raw-signal cache in the reference's on-disk format
    # (u64 nsample, f32[] raw, f32 dig/offset/range/rate per record,
    # sequential in BAM order; f5cio.c:321-344, 389-397)
    write_dump: str | None = None
    read_dump: str | None = None
    # unreadable signal records: skip-and-count (default) or abort,
    # mirroring F5C_SKIP_UNREADABLE (f5cio.c:308-318, 435-447)
    skip_unreadable: bool = True
    # stop after N batches (reference --debug-break, meth_main.c:640)
    debug_break: int = -1
    # print the stage_detail breakdown at exit (reference --profile-cpu
    # forces staged timing, f5c.c:911; our pipeline is always staged)
    profile_detail: bool = False
    # multi-host data parallelism: this process handles BAM records with
    # read_idx % shard_count == shard_index; outputs merge
    # deterministically by read index (SURVEY §2.7 / parallel/mesh.py)
    shard_index: int = 0
    shard_count: int = 1
    # jax.distributed mode (parallel/distributed.py): tag each read's
    # output rows with a "#f5c-dist\t<read_idx>" marker line so shard
    # part-files k-way merge back into exact BAM order
    dist_markers: bool = False


@dataclass
class ReadRecord:
    """One loaded read: BAM info + sequence + events + scaling state."""

    qname: str
    read_idx: int
    tid: int
    pos: int
    cigar: list
    is_reverse: bool
    seq: str
    flag: int = 0
    mapq: int = 60
    nm: int = 0
    nsample: int = 0
    event_means: np.ndarray | None = None
    n_events: int = 0
    scaling: object = None
    events_per_base: float = 0.0
    b2e_start: np.ndarray | None = None
    b2e_stop: np.ndarray | None = None
    pairs: np.ndarray | None = None
    status: int = 0          # FAILED_* flags
    sample_rate: float = 0.0
    signal_path: str = ""
    raw_pa: np.ndarray | None = None   # kept only when emitters need samples
    qual: str = "*"                    # original base qualities (SAM v2)
    sam_aux: tuple = ()                # original aux tags rendered as SAM
    event_starts: np.ndarray | None = None
    event_lengths: np.ndarray | None = None
    event_stdvs: np.ndarray | None = None


# --- worker-side load (runs in subprocesses) -------------------------------

_W = {}
# guards the shared signal reader when _worker_load runs on threads
# (the per-thread native prep is GIL-released and needs no lock)
_W_FETCH_LOCK = __import__("threading").Lock()


def _spawn_worker_init(model_kind: str, model_path: str | None, rna: bool):
    """Initializer of the spawned load workers: they only read signals
    and detect events on the host, and must never open a GPU client
    (one JAX process per card)."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    _worker_init(model_kind, model_path, rna)


def _worker_init(model_kind: str, model_path: str | None, rna: bool):
    from ..models import builtin_model, load_model_file

    key = (model_kind, model_path)
    _W["rna"] = rna
    if _W.get("model_key") == key:
        return      # per-batch re-init must not re-parse the model file
    if model_path:
        _W["model"] = load_model_file(model_path)
    else:
        _W["model"] = builtin_model(model_kind)
    _W["model_key"] = key


def _fetch_signal(qname: str, path: str):
    """Raw signal fetch for one read (shared reader, lock-guarded);
    returns the signal record or None on a bad/unreadable record."""
    rd = _W.get("read_dump")
    if rd is not None:
        # sequential raw-dump cache (reference --read-dump,
        # f5cio.c:321-344): records follow BAM iteration order, so the
        # loader runs inline single-process in dump mode
        import struct

        from ..io.fast5 import Signal

        hdr = rd.read(8)
        if len(hdr) != 8:
            sys.stderr.write(
                f"[f5c-tpu] ERROR: raw dump exhausted at read "
                f"[{qname}] — the dump was written with a different "
                f"BAM/filter set (or is truncated); re-create it with "
                f"--write-dump on this exact command line\n")
            raise SystemExit(1)
        n = struct.unpack("<Q", hdr)[0]
        if n == 0:
            return None
        raw = np.fromfile(rd, np.float32, n)
        params = np.fromfile(rd, np.float32, 4)
        if raw.shape[0] != n or params.shape[0] != 4:
            sys.stderr.write(
                f"[f5c-tpu] ERROR: raw dump truncated mid-record at "
                f"read [{qname}]\n")
            raise SystemExit(1)
        dig, off, rng, rate = params
        return Signal(raw=raw, digitisation=float(dig),
                      offset=float(off), range=float(rng),
                      sample_rate=float(rate), read_id=qname)
    try:
        if path.endswith(".blow5") or path.endswith(".slow5"):
            # the shared reader's file handle needs the lock only for
            # the seek+read; decompression runs lock-free so threaded
            # loaders decode records in parallel (slow5_mt.c's role)
            with _W_FETCH_LOCK:
                f5 = _W.get("slow5")
                if f5 is None or f5.path != path:
                    from ..io.slow5 import Slow5File

                    f5 = _W["slow5"] = Slow5File(path)
                data = f5.read_record_bytes(qname)
            sig = f5.decode_record(data, qname)
        else:
            with _W_FETCH_LOCK:
                from ..io.fast5 import read_fast5_signal

                sig = read_fast5_signal(path, read_id=qname)
    except (OSError, KeyError, RuntimeError, ValueError, EOFError):
        # missing record, truncated/corrupt file, codec failure — all
        # normalised by the IO layer; skip-and-count (f5cio.c:435-447)
        return None
    return sig if sig.nsample else None


def _worker_fetch(args):
    """signal fetch + pA only — the load stage of the DEVICE events
    engine, where detection runs batched on the accelerator."""
    qname, path = args
    sig = _fetch_signal(qname, path)
    if sig is None:
        return qname, None
    return qname, (sig.to_pa(), sig.nsample, sig.sample_rate)


def _worker_load(args):
    """signal fetch + pA + events + MoM for one read (events.c path)."""
    qname, path, seq, keep_raw = args
    model = _W["model"]
    rna = _W["rna"]
    sig = _fetch_signal(qname, path)
    wd = _W.get("write_dump")
    if sig is None:
        if wd is not None:
            # bad record: a zero-length header keeps ordinals aligned
            # (f5cio.c:369-372)
            wd.write((0).to_bytes(8, "little"))
        return qname, None
    if wd is not None:
        wd.write(int(sig.nsample).to_bytes(8, "little"))
        np.asarray(sig.raw, np.float32).tofile(wd)
        np.array([sig.digitisation, sig.offset, sig.range,
                  sig.sample_rate], np.float32).tofile(wd)
    if _W.get("print_raw"):
        # reference format: ">qname\tPATH:path\tLN:n" + int samples
        # (f5cio.c:380-388); only the inline single-process loader sets
        # this flag, so prints stay in BAM order
        sys.stdout.write(f">{qname}\tPATH:{path}\tLN:{sig.nsample}\n")
        sys.stdout.write("\t".join(
            str(int(v)) for v in np.asarray(sig.raw)) + "\t\n")
    from .. import native
    ranks = None
    if (native.available() and sig.raw.dtype == np.int16
            and sig.raw.flags.c_contiguous):
        # one native call for the whole event_single stage
        et, ranks, sc, pa = native.prep_read(
            sig.raw, sig.digitisation, sig.offset, sig.range, seq,
            model.k, model.level_mean, rna=rna, keep_pa=keep_raw)
    else:
        pa = sig.to_pa()
        if native.available():
            et = native.detect_events(pa, rna=rna)
            ranks = native.kmer_ranks(seq, model.k)
            sc = native.mom_scalings(et.mean, ranks, model.level_mean)
        else:
            from ..ops.abea_ref import estimate_scalings_using_mom
            from ..ops.events_ref import detect_events

            et = detect_events(pa, rna=rna)
            sc = estimate_scalings_using_mom(seq, model, et.mean)
        if not keep_raw:
            pa = None
    return qname, _finish_load(model, rna, seq, et.start, et.length,
                               et.mean, et.stdv, sig.nsample,
                               sig.sample_rate, pa, ranks=ranks, sc=sc)


def _worker_load_many(items):
    """Batched host load for the single-worker wave path: per-read
    signal fetch, then ONE lane-parallel native detect call (16 reads
    per AVX-512 register in the peak scan — the largest single host
    detect component), then per-read ranks + MoM.  Byte-identical to
    mapping _worker_load (the threaded path keeps per-read prep_read,
    which scales with host cores instead)."""
    from .. import native

    if not native.available():
        return [_worker_load(it) for it in items]
    from ..ops.abea_ref import Scalings

    model = _W["model"]
    rna = _W["rna"]
    n = len(items)
    out = [None] * n
    sigs = [None] * n
    for j, (qname, path, seq, keep_raw) in enumerate(items):
        sig = _fetch_signal(qname, path)
        if sig is None:
            out[j] = (qname, None)
        else:
            sigs[j] = sig
    todo = [j for j in range(n) if sigs[j] is not None
            and sigs[j].raw.dtype == np.int16
            and sigs[j].raw.flags.c_contiguous]
    # non-int16 raws (only the raw-dump cache produces them, which
    # never reaches the wave loader) go through the per-read fallback
    for j in range(n):
        if out[j] is None and j not in set(todo):
            qname, path, seq, keep_raw = items[j]
            pa = np.ascontiguousarray(sigs[j].to_pa(), np.float32)
            et = native.detect_events(pa, rna=rna)
            ranks = native.kmer_ranks(seq, model.k)
            sc = (native.mom_scalings(et.mean, ranks, model.level_mean)
                  if et.mean.shape[0] and ranks.shape[0]
                  else Scalings(shift=0.0, scale=1.0))
            out[j] = (qname, _finish_load(
                model, rna, seq, et.start, et.length, et.mean, et.stdv,
                sigs[j].nsample, sigs[j].sample_rate,
                pa if keep_raw else None, ranks=ranks, sc=sc))
    if todo:
        keep_raw = items[todo[0]][3]
        prepped = native.prep_reads_many(
            [sigs[j] for j in todo], [items[j][2] for j in todo],
            model.k, model.level_mean, rna=rna, keep_pa=keep_raw)
        for j, (et, ranks, sc, pa) in zip(todo, prepped):
            qname, path, seq, _kr = items[j]
            s = sigs[j]
            out[j] = (qname, _finish_load(
                model, rna, seq, et.start, et.length, et.mean, et.stdv,
                s.nsample, s.sample_rate, pa, ranks=ranks, sc=sc))
    return out


def _finish_load(model, rna, seq, starts, lengths, means, stdvs,
                 nsample, sample_rate, raw_pa, ranks=None, sc=None):
    """Shared tail of both event-detection engines: ranks + MoM (when
    the caller has not already computed them) + the post-MoM RNA event
    reversal (f5c.c:711-721) + the loaded-read dict."""
    from .. import native

    if sc is None:
        if native.available():
            if ranks is None:
                ranks = native.kmer_ranks(seq, model.k)
            sc = native.mom_scalings(means, ranks, model.level_mean)
        else:
            from ..ops.abea_ref import estimate_scalings_using_mom

            sc = estimate_scalings_using_mom(seq, model, means)
    if rna:
        means, starts = means[::-1].copy(), starts[::-1].copy()
        lengths, stdvs = lengths[::-1].copy(), stdvs[::-1].copy()
    return dict(
        event_means=means, scaling=sc, sample_rate=sample_rate,
        event_starts=starts, event_lengths=lengths, event_stdvs=stdvs,
        nsample=nsample, ranks=ranks, raw_pa=raw_pa,
    )


class Pipeline:
    """call-methylation / eventalign runtime."""

    @classmethod
    def bare(cls, opt: "Options", model, cpg_model=None):
        """Compute-only pipeline (no BAM/genome/readdb) — used by
        resquiggle, which feeds ReadRecords directly."""
        self = object.__new__(cls)
        self.opt = opt
        self.model = model
        self.cpg_model = cpg_model
        self._model_kind = ("rna004_nucleotide" if opt.rna
                            and opt.pore == "rna004"
                            else "rna_r9_nucleotide" if opt.rna
                            else "dna_r9_nucleotide")
        self.bam = None
        self.genome = None
        self.readdb = None
        self.counters = dict(
            total_reads=0, unmapped=0, low_mapq=0, secondary=0,
            bad_signal=0, failed_calibration=0, failed_alignment=0,
            qc_fail=0, processed=0, ultra_long_skipped=0)
        self.stage_time = dict(load=0.0, events=0.0, align=0.0,
                               scaling=0.0, hmm=0.0, output=0.0)
        self.stage_detail = collections.defaultdict(float)
        self.engines = {}
        self.regions = None
        self.clip_start = -1
        self.clip_end = -1
        self._ultra_records = []
        self._n_batches = 0
        self._trace_budget_splits = 0
        return self

    def __init__(self, bam_path: str, genome_path: str, reads_path: str,
                 opt: Options | None = None):
        self.opt = opt or Options()
        if self.opt.slow5_path:
            rna, pore = detect_pore_from_slow5(self.opt.slow5_path)
            if rna is not None and not self.opt.rna:
                self.opt.rna = rna
            if pore is not None and self.opt.pore == "r9":
                self.opt.pore = pore
        self.bam = BamReader(bam_path)
        self.genome = FastaIndex(genome_path)
        self.readdb = ReadDB(reads_path).load()
        if self.opt.kmer_model_path:
            self.model = load_model_file(self.opt.kmer_model_path)
        elif self.opt.pore == "r10" and not self.opt.rna:
            # the reference ships the R10.4.1 9-mer tables as built-ins
            # (src/model.h DNA_R10_NUCLEOTIDE, f5cmisc.h:24-30); those
            # blobs are not redistributable here, so demand an explicit
            # model instead of silently scoring R10 signal with the R9
            # 6-mer table
            raise RuntimeError(
                "--pore r10 needs an explicit k=9 model: pass "
                "--kmer-model <file> (ONT r10.4.1 9-mer table; convert "
                "a text model with scripts/convert_models.py, format as "
                "in test/r9-models/*.model)")
        elif self.opt.rna:
            self.model = builtin_model(
                "rna004_nucleotide" if self.opt.pore == "rna004"
                else "rna_r9_nucleotide")
        else:
            self.model = builtin_model("dna_r9_nucleotide")
        if self.opt.meth_model_path:
            self.cpg_model = load_model_file(self.opt.meth_model_path,
                                             alphabet="meth")
        elif self.opt.pore == "r10" and not self.opt.rna:
            # eventalign does not need it; call_methylation errors below
            self.cpg_model = None
        else:
            self.cpg_model = builtin_model("dna_r9_cpg")
        self._model_kind = ("rna004_nucleotide" if self.opt.rna
                            and self.opt.pore == "rna004"
                            else "rna_r9_nucleotide" if self.opt.rna
                            else "dna_r9_nucleotide")
        self.counters = dict(
            total_reads=0, unmapped=0, low_mapq=0, secondary=0,
            bad_signal=0, failed_calibration=0, failed_alignment=0,
            qc_fail=0, processed=0, ultra_long_skipped=0)
        self.stage_time = dict(load=0.0, events=0.0, align=0.0,
                               scaling=0.0, hmm=0.0, output=0.0)
        # fine-grained host/transfer/device accounting inside the stages
        # (keys like "align.walk_sync", "hmm.h2d_bytes", "hmm.n_dispatch")
        # — printed by --profile-cpu and the benchmark
        self.stage_detail = collections.defaultdict(float)
        self.engines = {}
        self._n_batches = 0
        self._trace_budget_splits = 0
        # genomic window(s): -w chr:start-end or a .bed list
        self.regions = None          # list of (chrom, start, end)
        self.clip_start = -1
        self.clip_end = -1
        if self.opt.region_str:
            self.regions = parse_regions(self.opt.region_str)
            if len(self.regions) == 1:
                _, self.clip_start, self.clip_end = self.regions[0]
        self._ultra_records = []

    def _in_region(self, rec) -> bool:
        name = self.bam.references[rec.tid]
        end = rec.ref_end()
        for chrom, start, stop in self.regions:
            if chrom == name and rec.pos < stop and end > start:
                return True
        return False

    def _bam_record_iter(self):
        """Region-aware record source: seek via the BAI when `-w` regions
        are given and an index exists (sam_itr_queryi equivalent,
        f5cio.c:476-514); otherwise stream the whole file."""
        if self.regions is not None and self.bam.has_index():
            tid_of = {n: i for i, n in enumerate(self.bam.references)}
            for chrom, start, stop in self.regions:
                tid = tid_of.get(chrom)
                if tid is None:
                    continue
                yield from self.bam.fetch(tid, start, stop)
        else:
            yield from self.bam

    # ---- batch iteration ------------------------------------------------
    def batches(self, keep_raw: bool = False, load: bool = True):
        """Yield lists of ReadRecord (loaded, events+MoM done).  With
        ``load=False``, yield the filtered records with signals NOT yet
        fetched — the wave-pipelined align path loads them interleaved
        with device dispatches (align_batch_waved)."""
        opt = self.opt
        import multiprocessing as mp

        # per-run batch counter: --debug-break counts this iteration's
        # batches, not the pipeline object's lifetime total
        self._n_batches = 0
        dump_mode = bool(opt.write_dump or opt.read_dump)
        if not load or opt.num_proc <= 1 or opt.print_raw or dump_mode:
            # single host core: run loads inline, no IPC overhead
            _worker_init(self._model_kind, opt.kmer_model_path, opt.rna)
            pool = None
            if (opt.print_raw or dump_mode) and opt.num_proc > 1:
                # mirror the reference, which refuses --print-raw and
                # raw dumps with --iop (f5c.c:557-568): keep the
                # sequential record order
                sys.stderr.write("[f5c-tpu] --print-raw/--write-dump/"
                                 "--read-dump force single-process "
                                 "loading\n")
            # set (or clear, for later pipelines in this process) the
            # module-level flags the inline loader consults
            _W["print_raw"] = bool(opt.print_raw and load)
            _W["write_dump"] = (open(opt.write_dump, "wb")
                                if load and opt.write_dump else None)
            _W["read_dump"] = (open(opt.read_dump, "rb")
                               if load and opt.read_dump else None)
        else:
            # spawn: forking a process with a live device client is unsafe
            pool = ProcessPoolExecutor(
                max_workers=opt.num_proc,
                mp_context=mp.get_context("spawn"),
                initializer=_spawn_worker_init,
                initargs=(self._model_kind, opt.kmer_model_path, opt.rna))
        try:
            batch: list[ReadRecord] = []
            bases = 0
            read_idx = 0
            for rec in self._bam_record_iter():
                idx = read_idx
                read_idx += 1
                if opt.shard_count > 1 and (
                        idx % opt.shard_count != opt.shard_index):
                    continue
                if rec.is_unmapped:
                    self.counters["unmapped"] += 1
                    continue
                if rec.mapq < opt.min_mapq:
                    self.counters["low_mapq"] += 1
                    continue
                if rec.is_secondary and not opt.keep_secondary:
                    self.counters["secondary"] += 1
                    continue
                if self.regions is not None and not self._in_region(rec):
                    continue
                seq = self.readdb.get_read_sequence(rec.qname)
                path = opt.slow5_path or self.readdb.get_signal_path(
                    rec.qname)
                if not seq or not path:
                    self.counters["bad_signal"] += 1
                    continue
                if opt.rna:
                    seq = seq.replace("U", "T")
                if (opt.skip_ultra is not None
                        and len(seq) > opt.ultra_thresh):
                    # defer ultra-long reads to a second pass
                    # (f5cio.c:573-578)
                    self.counters["ultra_long_skipped"] += 1
                    self._ultra_records.append(rec)
                    continue
                self.counters["total_reads"] += 1
                batch.append(ReadRecord(
                    qname=rec.qname, read_idx=idx, tid=rec.tid, pos=rec.pos,
                    cigar=rec.cigar, is_reverse=rec.is_reverse, seq=seq,
                    flag=rec.flag, mapq=rec.mapq,
                    nm=rec.aux_int("NM") if hasattr(rec, "aux_int") else 0,
                    qual=rec.qual if hasattr(rec, "qual") else "*",
                    sam_aux=(tuple(rec.aux_sam_tags())
                             if hasattr(rec, "aux_sam_tags") else ()),
                    signal_path=path))
                bases += len(seq)
                if len(batch) >= opt.batch_reads or bases >= opt.batch_bases:
                    if opt.verbose >= 1:
                        sys.stderr.write(
                            f"[f5c-tpu] {len(batch)} entries "
                            f"({bases/1e6:.1f}M bases) loaded\n")
                    self._n_batches += 1
                    yield (self._load_batch(pool, batch, keep_raw)
                           if load else batch)
                    batch, bases = [], 0
                    if self._n_batches == opt.debug_break:
                        # reference --debug-break: stop after N batches
                        # (meth_main.c:640)
                        return
            if batch:
                if opt.verbose >= 1:
                    sys.stderr.write(
                        f"[f5c-tpu] {len(batch)} entries "
                        f"({bases/1e6:.1f}M bases) loaded\n")
                self._n_batches += 1
                yield (self._load_batch(pool, batch, keep_raw)
                       if load else batch)
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
            _W["print_raw"] = False
            for key in ("write_dump", "read_dump"):
                fh = _W.get(key)
                if fh is not None:
                    fh.close()
                    _W[key] = None
            if self._ultra_records and opt.skip_ultra:
                from ..io.bam import write_bam

                write_bam(opt.skip_ultra,
                          list(zip(self.bam.references,
                                   self.bam.ref_lengths)),
                          self._ultra_records)
                sys.stderr.write(
                    f"[f5c-tpu] {len(self._ultra_records)} ultra-long "
                    f"reads (> {opt.ultra_thresh} bases) written to "
                    f"{opt.skip_ultra} for a second pass\n")

    def _load_batch(self, pool, batch, keep_raw):
        t0 = time.time()
        dump_mode = bool(self.opt.read_dump or self.opt.write_dump
                         or self.opt.print_raw)
        if dump_mode and self._events_engine() == "device":
            # dumps/print-raw need the sequential host fetch order; be
            # loud that detection therefore runs on the host
            if not getattr(self, "_warned_dump_host", False):
                self._warned_dump_host = True
                sys.stderr.write(
                    "[f5c-tpu] --print-raw/--write-dump/--read-dump "
                    "use the sequential host loader; events-engine "
                    "device is ignored for this run\n")
        if batch and not dump_mode and self._events_engine() == "device":
            # plain (non-wave) loader with the on-device detector
            # (fetch threads via _host_pool; the worker process pool is
            # bypassed — an explicit --events-engine device must not
            # silently fall back to host detection just because
            # num_proc > 1).  Detect in length-sorted 32-read chunks so
            # the padded (B, S_max) signal slab never blows up on one
            # long read (the wave schedule's shape discipline).
            order = sorted(range(len(batch)),
                           key=lambda i: len(batch[i].seq))
            results = [None] * len(batch)
            for c0 in range(0, len(order), 32):
                w = order[c0:c0 + 32]
                for j, r in zip(w, self._load_wave_device(
                        w, batch, keep_raw)):
                    results[j] = r
            results = [(batch[i].qname, results[i][1])
                       for i in range(len(batch))]
        else:
            args = [(r.qname, r.signal_path, r.seq, keep_raw)
                    for r in batch]
            results = (map(_worker_load, args) if pool is None
                       else pool.map(_worker_load, args))
        for r, (qname, data) in zip(batch, results):
            assert qname == r.qname
            self._populate_read(r, data)
        self.stage_time["events"] += time.time() - t0
        return batch

    def _populate_read(self, r: ReadRecord, data) -> bool:
        if data is None:
            self.counters["bad_signal"] += 1
            if not self.opt.skip_unreadable:
                # --skip-unreadable=no aborts like the reference
                # (f5cio.c:313-316, 441-444)
                sys.stderr.write(
                    f"[f5c-tpu] ERROR: signal record for read "
                    f"[{r.qname}] ({r.signal_path}) is unavailable/"
                    f"unreadable\n")
                raise SystemExit(1)
            r.status |= FAILED_ALIGNMENT
            return False
        r.event_means = data["event_means"]
        r.n_events = r.event_means.shape[0]
        r.scaling = data["scaling"]
        r.sample_rate = data["sample_rate"]
        r.event_starts = data["event_starts"]
        r.event_lengths = data["event_lengths"]
        r.event_stdvs = data["event_stdvs"]
        r.nsample = data["nsample"]
        r.raw_pa = data["raw_pa"]
        r.ranks = data.get("ranks")
        return True

    def _host_pool(self, n_items: int):
        """Shared thread pool for GIL-released native per-read work
        (load prep, postalign, CpG collect), or None when one worker
        (or a tiny item count) makes threading pointless.
        F5C_TPU_POST_THREADS overrides the cpu_count default."""
        n_workers = int(os.environ.get("F5C_TPU_POST_THREADS",
                                       os.cpu_count() or 1))
        if n_workers <= 1 or n_items <= 3:
            return None
        pool = getattr(self, "_post_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor
            pool = self._post_pool = ThreadPoolExecutor(
                max_workers=min(n_workers, 8))
        return pool

    def _events_engine(self) -> str:
        """Resolve the event-detection engine.

        "auto" takes the native host detector whenever the native
        library is available (event means must return to the host either
        way for MoM/recalibration bit-parity and emission,
        src/f5c.c:691-745), and the batched device detector
        (ops/events_device.py) only without it."""
        cached = getattr(self, "_events_engine_cached", None)
        if cached is not None:
            return cached
        eng = (getattr(self.opt, "events_engine", None)
               or os.environ.get("F5C_TPU_EVENTS_ENGINE", "auto"))
        if eng == "auto":
            eng = os.environ.get("F5C_TPU_EVENTS_ENGINE", "auto")
        if eng not in ("host", "device"):    # resolve auto
            from .. import native

            eng = "host" if native.available() else "device"
        self._events_engine_cached = eng
        self.engines["events"] = eng
        return eng

    def _load_wave_device(self, w, batch, keep_raw: bool):
        """Load stage of the DEVICE events engine: fetch raw signals,
        run the batched on-device detector, then per-read ranks + MoM
        on the host (they are inputs to the host-side QC/recalibration
        path either way).  Returns (qname, data) pairs shaped exactly
        like _worker_load's output."""
        from ..ops.events_device import detect_events_batch

        rna = self.opt.rna
        model = self.model
        args = [(batch[i].qname, batch[i].signal_path) for i in w]
        pool = self._host_pool(len(w))
        fetched = list(pool.map(_worker_fetch, args) if pool is not None
                       else map(_worker_fetch, args))
        live = [j for j, (_, f) in enumerate(fetched) if f is not None]
        results = [None] * len(fetched)
        if live:
            from ..ops import route

            # on the CPU the op runs un-jitted: IEEE div/sqrt,
            # bit-exact with the host engine
            tables = detect_events_batch(
                [fetched[j][1][0] for j in live], rna=rna,
                eager=route.platform() == route.CPU)
            for j, (st, ln, mn, sd) in zip(live, tables):
                pa, nsample, rate = fetched[j][1]
                results[j] = _finish_load(
                    model, rna, batch[w[j]].seq, st, ln, mn, sd,
                    nsample, rate, pa if keep_raw else None)
        return [(qname, results[j])
                for j, (qname, _) in enumerate(fetched)]

    # ---- device stages ---------------------------------------------------
    @staticmethod
    def _mesh_devices():
        import jax

        if os.environ.get("F5C_TPU_MESH", "1") == "0":
            return []
        # local devices only: under jax.distributed (--dist) each process
        # owns its read shard, so intra-process meshes must not span
        # other processes' (non-addressable) devices
        devs = jax.local_devices()
        return devs if len(devs) > 1 else []

    def _nuc_dev_tables(self):
        """Device-resident nucleotide model tables (cached)."""
        if not hasattr(self, "_nuc_dev"):
            import jax.numpy as jnp

            m = self.model
            self._nuc_dev = (jnp.asarray(m.level_mean),
                             jnp.asarray(m.level_stdv),
                             jnp.asarray(m.level_log_stdv))
        return self._nuc_dev

    # device trace memory budget per ABEA launch (the reference sizes
    # its GPU arena the same way, f5c.cu:110-157); tunable via
    # F5C_TPU_TRACE_BYTES
    TRACE_BYTES_BUDGET = int(os.environ.get("F5C_TPU_TRACE_BYTES",
                                            4_000_000_000))

    def _ranks_for(self, todo):
        """Kmer ranks per read (prep_read computed them during load;
        recompute only for reads that came through a fallback loader)."""
        from .. import native

        if native.available():
            return {id(r): (r.ranks if getattr(r, "ranks", None)
                            is not None
                            else native.kmer_ranks(r.seq, self.model.k))
                    for r in todo}
        return {id(r): self.model.kmer_ranks(r.seq).astype(np.int32)
                for r in todo}

    def _launch_groups(self, todo, ev_off, ev_len, rk_off, rk_len):
        """Split reads (in order) into ABEA launches: an ultra-long read
        (> --ultra-thresh bases) takes a launch of its own, and a launch
        grows only while its device trace fits TRACE_BYTES_BUDGET.
        Returns [(lo, hi, plan)] over index ranges of ``todo``."""
        from ..ops import route
        from ..ops.abea import plan_launch

        plat = route.platform()

        def plan(lo, hi):
            return plan_launch(ev_off[lo:hi], ev_len[lo:hi], rk_off[lo:hi],
                               rk_len[lo:hi],
                               [r.scaling.scale for r in todo[lo:hi]],
                               [r.scaling.shift for r in todo[lo:hi]])

        ultra = [len(r.seq) > self.opt.ultra_thresh for r in todo]
        groups, lo = [], 0
        while lo < len(todo):
            hi = lo + 1
            if not ultra[lo]:
                hi = len(todo)
                for j in range(lo + 1, len(todo)):
                    if ultra[j]:
                        hi = j
                        break
            p = plan(lo, hi)
            while hi - lo > 1 and p.trace_bytes(plat) > self.TRACE_BYTES_BUDGET:
                self._trace_budget_splits += 1
                hi = lo + (hi - lo) // 2
                p = plan(lo, hi)
            groups.append((lo, hi, p))
            lo = hi
        return groups

    def align_batch(self, batch: list[ReadRecord]):
        """ABEA on device for all loadable reads; fills pairs + scaling.

        One device: the batch's event/rank pools go to the device once
        (async H2D), every launch is dispatched back-to-back without
        waiting, and the host decodes each launch's compact walk while
        the device aligns the next — the analogue of the reference's
        concurrent CPU/GPU split (f5c.cu:647-1061).  The uploaded event
        pool is reused by the HMM stage.  Several local devices: reads
        are dealt over the mesh (_align_sharded).
        """
        self._hmm_pool = None
        todo = []
        for r in batch:
            if r.status or r.event_means is None:
                continue
            if r.n_events / len(r.seq) >= AVG_EVENTS_PER_KMER_MAX:
                r.status |= FAILED_ALIGNMENT
                continue
            todo.append(r)
        if not todo:
            return
        todo.sort(key=lambda r: r.n_events)
        ranks = self._ranks_for(todo)
        devs = self._mesh_devices()
        if devs and len(todo) >= len(devs):
            return self._align_sharded(todo, ranks, devs)
        return self._align_bucketed_async(todo, ranks)

    def _align_bucketed_async(self, todo: list[ReadRecord], ranks: dict):
        """Multi-launch ABEA against batch-wide pools, deferred sync."""
        import jax.numpy as jnp

        t0 = time.time()
        # ---- batch-wide pools, ONE async H2D ----
        ev_len_all = np.array([r.n_events for r in todo], np.int32)
        rk_list = [ranks[id(r)] for r in todo]
        rk_len_all = np.array([k.shape[0] for k in rk_list], np.int32)
        ev_off_all = np.zeros(len(todo), np.int32)
        np.cumsum(ev_len_all[:-1], out=ev_off_all[1:])
        rk_off_all = np.zeros(len(todo), np.int32)
        np.cumsum(rk_len_all[:-1], out=rk_off_all[1:])
        ev_pool = np.zeros(_pool_bucket(int(ev_len_all.sum())), np.float32)
        pos = 0
        for r in todo:
            ev_pool[pos:pos + r.n_events] = r.event_means
            pos += r.n_events
        rk_dtype = np.int16 if self.model.num_kmers <= 32767 else np.int32
        rk_pool = np.zeros(_pool_bucket(int(rk_len_all.sum())), rk_dtype)
        pos = 0
        for k in rk_list:
            rk_pool[pos:pos + k.shape[0]] = k
            pos += k.shape[0]
        ev_pool_dev = jnp.asarray(ev_pool)      # async H2D, overlaps below
        rk_pool_dev = jnp.asarray(rk_pool)
        self._hmm_pool = (ev_pool_dev,
                          {id(r): int(o) for r, o in zip(todo, ev_off_all)})

        # ---- dispatch every launch without waiting ----
        launches = []
        for lo, hi, plan in self._launch_groups(
                todo, ev_off_all, ev_len_all, rk_off_all, rk_len_all):
            g = todo[lo:hi]
            out = self._dispatch_abea(ev_pool_dev, rk_pool_dev, g, plan)
            launches.append((g, plan, out))
        self.stage_time["align"] += time.time() - t0

        # ---- sync in order; host decode overlaps later launches ----
        for g, plan, (flat, start_e, n) in launches:
            t0 = time.time()
            flat = np.asarray(flat)
            start_e = np.asarray(start_e)
            n = np.asarray(n)
            self.stage_time["align"] += time.time() - t0
            t0 = time.time()
            off = plan.byte_off
            for i, r in enumerate(g):
                if start_e[i] < 0 or n[i] == 0:
                    r.status |= FAILED_ALIGNMENT
                    continue
                self._postalign_qc_one(r, ranks[id(r)],
                                       flat[off[i]:off[i + 1]],
                                       int(n[i]), int(start_e[i]),
                                       r.scaling.scale, r.scaling.shift)
            self.stage_time["scaling"] += time.time() - t0

    def _dispatch_abea(self, ev_pool_dev, rk_pool_dev, group, plan):
        """One ABEA launch (ops/route.py picks the implementation) for
        ``group`` against device-resident event/rank pools.  Returns the
        device outputs (flat walk, start_e, n); their D2H copy is
        started asynchronously."""
        import jax.numpy as jnp

        from ..ops import route

        lm, ls, ll = self._nuc_dev_tables()
        t_disp = time.time()
        out = route.abea_impl()(
            ev_pool_dev, rk_pool_dev, jnp.asarray(plan.meta_i),
            jnp.asarray(plan.meta_f), jnp.asarray(plan.byte_off),
            lm, ls, ll, **plan.statics)
        for a in out:
            a.copy_to_host_async()
        self.stage_detail["align.dispatch_enqueue"] += (time.time()
                                                        - t_disp)
        self.stage_detail["align.n_dispatch"] += 1
        # useful DP work dispatched: band cells = bands x 100 lanes
        self.stage_detail["align.band_cells"] += float(sum(
            (r.n_events + len(r.seq) - self.model.k + 3) * 100
            for r in group))
        self.stage_detail["align.n_events"] += float(
            sum(r.n_events for r in group))
        return out

    def supports_waves(self) -> bool:
        """The wave-pipelined schedule runs on one device with the
        native host library."""
        from .. import native

        return (native.available()
                and not self._mesh_devices()
                # --print-raw and the raw-dump cache emit/consume
                # records in BAM order at load time; the wave schedule
                # loads in length-sorted order, so those runs take the
                # plain loader (debug/cache != perf)
                and not self.opt.print_raw
                and not self.opt.write_dump
                and not self.opt.read_dump)

    def align_batch_waved(self, batch: list[ReadRecord],
                          keep_raw: bool = False,
                          meth_inline: bool = False,
                          wave_done=None):
        """Load + event-detect + ABEA for one batch as a host/device
        software pipeline.

        The batch is processed in length-sorted waves of ~32 reads:
        while the device fills wave N's bands, the host decodes wave
        N-1's compact walk (postalign/QC/recalibration) and detects
        events for wave N+1 — the reference's 3-stage pipeline +
        concurrent CPU/GPU split (meth_main.c:610-742, f5c.cu:647-1061)
        collapsed to one thread, with every transfer asynchronous.  Each
        wave's event slab is uploaded once and serves directly as that
        wave's HMM scoring pool.
        """
        import jax.numpy as jnp

        _worker_init(self._model_kind, self.opt.kmer_model_path,
                     self.opt.rna)
        self._hmm_pool = None
        # longest reads first: the biggest fill/HMM work is dispatched
        # while later waves still have host work to overlap it, and the
        # un-overlappable tail (final walk/score syncs after the last
        # wave) lands on the smallest wave instead of the largest
        order = sorted(range(len(batch)), key=lambda i: len(batch[i].seq),
                       reverse=True)
        WAVE = int(os.environ.get("F5C_TPU_WAVE", "32"))
        # launches kept outstanding: wave N's walk D2H gets the host work
        # of the next waves as cover
        self._inflight_depth = int(os.environ.get("F5C_TPU_INFLIGHT",
                                                  "3"))
        waves = [order[i:i + WAVE] for i in range(0, len(order), WAVE)]
        rk_dtype = np.int16 if self.model.num_kmers <= 32767 else np.int32
        launches: list = []
        sync_i = 0

        self._meth_states = [] if meth_inline else None
        self._meth_covered = set()

        def sync_one():
            """Sync + decode the oldest outstanding launch, then (for
            call-methylation) dispatch this wave's HMM scoring against
            the wave's own device slab — the scorer runs while later
            waves load and fill."""
            nonlocal sync_i
            (todo, ranks, plan, slab_dev, slab_off,
             (flat, start_e, n)) = launches[sync_i]
            launches[sync_i] = None
            sync_i += 1
            t0 = time.time()
            flat = np.asarray(flat)
            start_e = np.asarray(start_e)
            n = np.asarray(n)
            dt = time.time() - t0
            self.stage_time["align"] += dt
            # device fill + walk D2H wait for this wave (everything the
            # host could not overlap)
            self.stage_detail["align.walk_sync"] += dt
            self.stage_detail["align.d2h_bytes"] += flat.nbytes
            t0 = time.time()
            off = plan.byte_off

            def _post_one(i, r):
                if start_e[i] < 0 or n[i] == 0:
                    r.status |= FAILED_ALIGNMENT
                    return
                self._postalign_qc_one(r, ranks[id(r)],
                                       flat[off[i]:off[i + 1]],
                                       int(n[i]), int(start_e[i]),
                                       r.scaling.scale, r.scaling.shift)

            # per-read postalign is independent and runs inside a
            # single ctypes call (GIL released), so a thread pool
            # scales it with host cores — keeps single-CPU host
            # work from capping multi-chip speedup (f5c.cu's CPU
            # pthread pool analogue)
            pool = self._host_pool(len(todo))
            if pool is not None:
                list(pool.map(_post_one, range(len(todo)), todo))
            else:
                for i, r in enumerate(todo):
                    _post_one(i, r)
            dt = time.time() - t0
            self.stage_time["scaling"] += dt
            self.stage_detail["scaling.postalign_host"] += dt
            if meth_inline:
                t0 = time.time()
                ok = [r for r in todo
                      if not r.status and r.b2e_start is not None]
                if ok:
                    st = self._meth_prepare_dispatch(
                        ok, slab_dev,
                        np.array([slab_off[id(r)] for r in ok], np.int64))
                    if st is not None:
                        self._meth_states.append(st)
                    self._meth_covered.update(id(r) for r in ok)
                self.stage_time["hmm"] += time.time() - t0
            if wave_done is not None:
                # per-wave host continuation (eventalign realign): runs
                # while the device fills the NEXT wave's bands
                wave_done([r for r in todo
                           if not r.status and r.b2e_start is not None])

        events_engine = self._events_engine()
        for w in waves:
            # ---- load: signal fetch + event detection + MoM ----
            t0 = time.time()
            todo = []
            if events_engine == "device":
                # batched on-device detector (ops/events_device.py);
                # host keeps only fetch + ranks + MoM
                loaded = self._load_wave_device(w, batch, keep_raw)
            else:
                pool = self._host_pool(len(w))
                if pool is not None:
                    # fetch is serialised by _W_FETCH_LOCK; the native
                    # detect/ranks/MoM (prep_read) is GIL-released and
                    # scales across host cores
                    loaded = list(pool.map(
                        _worker_load,
                        [(batch[i].qname, batch[i].signal_path,
                          batch[i].seq, keep_raw) for i in w]))
                else:
                    loaded = _worker_load_many(
                        [(batch[i].qname, batch[i].signal_path,
                          batch[i].seq, keep_raw) for i in w])
            for i, (qname, data) in zip(w, loaded):
                r = batch[i]
                if not self._populate_read(r, data):
                    continue
                if r.n_events / len(r.seq) >= AVG_EVENTS_PER_KMER_MAX:
                    r.status |= FAILED_ALIGNMENT
                    continue
                todo.append(r)
            dt = time.time() - t0
            self.stage_time["events"] += dt
            self.stage_detail["events.load_host"] += dt

            t0 = time.time()
            ranks = self._ranks_for(todo)
            if not todo:
                self.stage_time["align"] += time.time() - t0
                continue

            # ---- async H2D: this wave's event slab + 2-bit seq ----
            ev_len = np.array([r.n_events for r in todo], np.int32)
            rk_len = np.array([len(r.seq) - self.model.k + 1
                               for r in todo], np.int32)
            ev_off = np.zeros(len(todo), np.int32)
            np.cumsum(ev_len[:-1], out=ev_off[1:])
            # 32k-granular slab lengths keep launch-shape variants low
            n_ev_wave = int(ev_len.sum())
            slab = np.zeros(((n_ev_wave + (1 << 15) - 1) >> 15) << 15,
                            np.float32)
            pos = 0
            for r in todo:
                slab[pos:pos + r.n_events] = r.event_means
                pos += r.n_events
            # ranks ride as 2-bit packed sequence (0.25 B/base instead
            # of 2 B/base) and are recomputed on-device with k shifted
            # adds — bit-identical to the host ranks for every kmer the
            # alignment reads (ops/seq_ranks.py)
            from ..ops.seq_ranks import pack_seqs, ranks_from_packed

            packed, rk_off = pack_seqs([r.seq for r in todo],
                                       pad_to=1 << 12)
            t_h2d = time.time()
            slab_dev = jnp.asarray(slab)
            rk_slab_dev = ranks_from_packed(
                jnp.asarray(packed), k=self.model.k,
                use_i16=(rk_dtype == np.int16))
            self.stage_detail["align.h2d_enqueue"] += time.time() - t_h2d
            self.stage_detail["align.h2d_bytes"] += (slab.nbytes
                                                    + packed.nbytes)

            # ---- dispatch this wave's fill+walk (no waiting) ----
            slab_off_map = {id(r): int(o) for r, o in zip(todo, ev_off)}
            for lo, hi, plan in self._launch_groups(todo, ev_off, ev_len,
                                                    rk_off, rk_len):
                part = todo[lo:hi]
                out = self._dispatch_abea(slab_dev, rk_slab_dev, part, plan)
                launches.append((part, ranks, plan, slab_dev, slab_off_map,
                                 out))
            self.stage_time["align"] += time.time() - t0

            # keep up to F5C_TPU_INFLIGHT launches outstanding: syncing
            # wave N only after wave N+depth has loaded gives N's walk
            # D2H the host work of the next waves as cover.  A wave can
            # emit several launches (ultra-long reads, trace-budget
            # splits), so drain to the cap
            while len(launches) - sync_i > self._inflight_depth:
                sync_one()

        while sync_i < len(launches):
            sync_one()

    def _align_sharded(self, todo, ranks, devs):
        """ABEA with the read axis data-parallel over the local devices
        (parallel/mesh.py:shard_abea).  Reads are dealt round-robin
        (todo is event-sorted, so lengths balance); each device gets its
        own event/rank pools and launch plan, placed on it directly."""
        from ..ops import route
        from ..ops.abea import plan_launch
        from ..parallel.mesh import (data_mesh, put_replicated,
                                     put_sharded, record_dispatch,
                                     shard_abea)

        t0 = time.time()
        D = len(devs)
        groups = [todo[d::D] for d in range(D)]
        rk_dtype = np.int16 if self.model.num_kmers <= 32767 else np.int32
        per_dev = []
        for g in groups:
            ev_len = np.array([r.n_events for r in g], np.int64)
            rk_len = np.array([ranks[id(r)].shape[0] for r in g], np.int64)
            ev_off = np.concatenate([[0], np.cumsum(ev_len)[:-1]])
            rk_off = np.concatenate([[0], np.cumsum(rk_len)[:-1]])
            per_dev.append((
                np.concatenate([r.event_means for r in g]).astype(
                    np.float32),
                np.concatenate([ranks[id(r)] for r in g]).astype(rk_dtype),
                (ev_off, ev_len, rk_off, rk_len,
                 [r.scaling.scale for r in g],
                 [r.scaling.shift for r in g])))
        plans = [plan_launch(*meta) for _, _, meta in per_dev]
        widest = tuple(map(max, zip(*(p.sizes for p in plans))))
        plans = [plan_launch(*meta, at_least=widest)
                 for _, _, meta in per_dev]
        L_e = _pool_bucket(max(ev.shape[0] for ev, _, _ in per_dev))
        L_r = _pool_bucket(max(rk.shape[0] for _, rk, _ in per_dev))

        def stack(arrs, n):
            out = np.zeros((D, n) + arrs[0].shape[1:], arrs[0].dtype)
            for d, a in enumerate(arrs):
                out[d, :a.shape[0]] = a
            return out

        sharded = (stack([ev for ev, _, _ in per_dev], L_e),
                   stack([rk for _, rk, _ in per_dev], L_r),
                   np.stack([p.meta_i for p in plans]),
                   np.stack([p.meta_f for p in plans]),
                   np.stack([p.byte_off for p in plans]))
        m = self.model
        tables = (m.level_mean, m.level_stdv, m.level_log_stdv)
        record_dispatch("align", sum(a.nbytes for a in sharded),
                        sum(t.nbytes for t in tables), D)
        mesh = data_mesh(devs)
        flat, start_e, n = shard_abea(
            mesh, route.abea_impl(),
            *(put_sharded(mesh, a) for a in sharded),
            *(put_replicated(mesh, t) for t in tables), **plans[0].statics)
        flat = np.asarray(flat)
        start_e = np.asarray(start_e)
        n = np.asarray(n)
        self.stage_time["align"] += time.time() - t0

        t0 = time.time()
        for d, group in enumerate(groups):
            off = plans[d].byte_off
            for i, r in enumerate(group):
                if start_e[d, i] < 0 or n[d, i] == 0:
                    r.status |= FAILED_ALIGNMENT
                    continue
                self._postalign_qc_one(r, ranks[id(r)],
                                       flat[d, off[i]:off[i + 1]],
                                       int(n[d, i]), int(start_e[d, i]),
                                       r.scaling.scale, r.scaling.shift)
        self.stage_time["scaling"] += time.time() - t0

    def _postalign_qc_one(self, r: ReadRecord, rks: np.ndarray,
                          dirs_bytes: np.ndarray, n: int, start_event: int,
                          mom_scale: float, mom_shift: float):
        """Host half of the ABEA launch contract: decode the packed
        walk, run the alignment QC (src/align.c:526-543 thresholds) and
        postalign + recalibration in one native pass."""
        from .. import native
        from ..ops import abea

        n_kmers = len(r.seq) - self.model.k + 1
        if native.available():
            (failed, ok, pairs, b2e_start, b2e_stop, epb, rc, sum_em,
             max_gap) = native.decode_qc_postalign(
                dirs_bytes, n, start_event, rks, r.event_means,
                self.model.level_mean, self.model.level_stdv,
                self.model.level_log_stdv, mom_scale, mom_shift,
                ABEA_MIN_AVG_LOG_EMISSION, ABEA_MAX_GAP_THRESHOLD,
                self.opt.min_num_events_to_rescale)
            # kept for --print-banded-aln and the full-set fixtures
            r.align_sum_emission = sum_em
            r.align_n_pairs = n
            r.align_max_gap = max_gap
            if failed:
                r.status |= FAILED_ALIGNMENT
                return
        else:
            from ..ops.scaling import postalign_np, recalibrate_np

            pairs = abea.decode_packed_dirs(dirs_bytes, n, start_event,
                                            n_kmers)
            m = self.model
            a = ((r.event_means[pairs[:, 1]]
                  - (np.float32(mom_scale) * m.level_mean[rks[pairs[:, 0]]]
                     + np.float32(mom_shift)))
                 / m.level_stdv[rks[pairs[:, 0]]])
            em = (np.float32(-0.918938)
                  - m.level_log_stdv[rks[pairs[:, 0]]]
                  + np.float32(-0.5) * a * a)
            # walk-order sequential f32 accumulation (oracle order)
            sum_em = float(np.cumsum(em[::-1].astype(np.float32))[-1]
                           ) if n else 0.0
            avg = sum_em / max(n, 1)
            # max run of consecutive skip moves, from the walk itself
            b = dirs_bytes[: (n + 3) // 4].astype(np.uint8)
            d = np.stack([(b >> 0) & 3, (b >> 2) & 3, (b >> 4) & 3,
                          (b >> 6) & 3], axis=1).reshape(-1)[:n]
            max_gap = 0
            run = 0
            for s in (d == 2):
                run = run + 1 if s else 0
                max_gap = max(max_gap, run)
            spanned = n > 0 and pairs[0, 0] == 0
            if (avg < ABEA_MIN_AVG_LOG_EMISSION or not spanned
                    or max_gap > ABEA_MAX_GAP_THRESHOLD or n == 0):
                r.status |= FAILED_ALIGNMENT
                return
            post = postalign_np(pairs, rks, n_kmers)
            ok, rc = recalibrate_np(
                self.model.level_mean, self.model.level_stdv, rks,
                r.event_means, post, self.opt.min_num_events_to_rescale)
            b2e_start = post.base_to_event_start
            b2e_stop = post.base_to_event_stop
            epb = post.events_per_base
        r.pairs = pairs
        if not ok or rc.var > MIN_CALIBRATION_VAR:
            r.status |= FAILED_CALIBRATION
            return
        if epb > MAX_EVENTS_PER_BASE:
            r.status |= FAILED_QUALITY_CHK
            return
        r.scaling = rc
        r.events_per_base = epb
        r.b2e_start = b2e_start
        r.b2e_stop = b2e_stop

    def meth_batch(self, batch: list[ReadRecord]):
        """CpG group collection + batched device HMM; returns
        {read -> MethCalls} (native path; struct-of-arrays) or
        {read -> {start_pos -> ScoredSite}} (fallback), keeping batch
        order."""
        from .. import native

        states = getattr(self, "_meth_states", None)
        if states is not None:
            # the wave pipeline already collected + dispatched scoring
            # per wave; finish the in-flight transfers and pick up any
            # reads it could not cover (ultra-long, oversized slabs)
            covered = self._meth_covered
            self._meth_states = None
            leftovers = [r for r in batch
                         if not r.status and r.b2e_start is not None
                         and id(r) not in covered]
            extra = (self._meth_batch_native(leftovers) if leftovers
                     else {})
            # lazy per-state resolution: the output loop queues early
            # reads' rows to the writer thread BEFORE blocking on the
            # tail waves' scores, and the device wait releases the GIL
            # — render and score-sync genuinely overlap, even on one
            # host core
            return _LazySites(self, states, extra)
        if native.available():
            return self._meth_batch_native(batch)
        from ..ops.hmm import hmm_forward_batch, make_hmm_batch
        from .methylation import collect_meth_groups

        t0 = time.time()
        work = []     # (read, group)
        for r in batch:
            if r.status or r.b2e_start is None:
                continue
            ref_len = self.genome.entries[
                self.bam.references[r.tid]].length
            ref_seq = self._fetch_ref_segment(r)
            for g in collect_meth_groups(
                    ref_seq, r.pos, r.cigar, r.is_reverse, len(r.seq),
                    r.b2e_start, self.cpg_model.k):
                work.append((r, g))
        if not work:
            self.stage_time["hmm"] += time.time() - t0
            return {}

        # flatten to items and bucket by event-window size so one huge
        # window doesn't inflate the padding for thousands of small ones
        items = []
        ev_arrays = []
        scalings = []
        epbs = []
        for r, g in work:
            for it in (g.unmeth, g.meth):
                items.append(it)
                ev_arrays.append(r.event_means)
                scalings.append(r.scaling)
                epbs.append(r.events_per_base)
        n_items = len(items)
        sizes = np.array([abs(i.event_stop_idx - i.event_start_idx) + 1
                          for i in items])
        scores = np.zeros(n_items, dtype=np.float32)
        buckets: dict[int, list[int]] = {}
        for j in range(n_items):
            buckets.setdefault(_bucket(int(sizes[j]), minimum=128),
                               []).append(j)
        for pad_e, idxs in sorted(buckets.items()):
            sub_items = [items[j] for j in idxs]
            pad_k = _bucket(max(len(i.seq) - self.cpg_model.k + 1
                                for i in sub_items), minimum=64)
            hb = make_hmm_batch(sub_items, [ev_arrays[j] for j in idxs],
                                self.cpg_model, [scalings[j] for j in idxs],
                                [epbs[j] for j in idxs], pad_e, pad_k)
            s = np.asarray(hmm_forward_batch(hb, pad_events=pad_e))
            scores[idxs] = s
        self.stage_time["hmm"] += time.time() - t0

        out: dict[int, dict] = {}
        for j, (r, g) in enumerate(work):
            site_map = out.setdefault(id(r), {})
            site = site_map.setdefault(g.site.start_position, g.site)
            site.ll_unmethylated = float(scores[2 * j])
            site.ll_methylated = float(scores[2 * j + 1])
        return out

    def _meth_batch_native(self, batch: list[ReadRecord]):
        """Native group collection + HMM bucket assembly, device scoring.

        Work items across all reads of the batch are flattened, bucketed by
        (event-window, kmer-window) padded shape — with the item count also
        padded to a power of two so compiled shapes are reused across
        batches — and scored with the batched device HMM.
        """
        import jax.numpy as jnp

        t0 = time.time()
        reads = [r for r in batch if not r.status and r.b2e_start is not None]
        if not reads:
            self.stage_time["hmm"] += time.time() - t0
            return {}
        # event pool: reuse the align stage's device-resident upload
        # when it covers this batch; otherwise build + upload here
        pool = getattr(self, "_hmm_pool", None)
        if pool is not None and all(id(r) in pool[1] for r in reads):
            ev_pool = pool[0]
            ev_off = np.array([pool[1][id(r)] for r in reads], np.int64)
        else:
            ev_lens = [r.event_means.shape[0] for r in reads]
            ev_off = np.zeros(len(reads), np.int64)
            np.cumsum(ev_lens[:-1], out=ev_off[1:])
            ev_concat = np.ascontiguousarray(
                np.concatenate([r.event_means for r in reads]),
                dtype=np.float32)
            pool_pad = np.zeros(_pool_bucket(ev_concat.shape[0]),
                                np.float32)
            pool_pad[:ev_concat.shape[0]] = ev_concat
            devs = self._mesh_devices()
            if devs:
                from ..parallel.mesh import data_mesh, put_replicated

                ev_pool = put_replicated(data_mesh(devs), pool_pad)
            else:
                ev_pool = jnp.asarray(pool_pad)
        state = self._meth_prepare_dispatch(reads, ev_pool, ev_off)
        self.stage_time["hmm"] += time.time() - t0
        if state is None:
            return {}
        return self._meth_finish([state])

    def _meth_prepare_dispatch(self, reads, ev_pool, ev_off):
        """Collect CpG groups + build window items + dispatch the device
        HMM for ``reads`` whose event windows live in ``ev_pool`` at
        per-read offsets ``ev_off``.  Returns opaque state for
        _meth_finish (scores are still on device, transfers in flight),
        or None when there is nothing to score."""
        import jax.numpy as jnp

        from .. import native
        from ..ops.hmm import hmm_forward_packed

        k = self.cpg_model.k
        t_col = time.time()
        # ref fetch stays serial (shared FastaIndex handle); the native
        # disambiguate + CpG collection is GIL-released and independent
        # per read, so it threads across host cores like postalign
        refs = [self._fetch_ref_segment(r).encode() for r in reads]

        def _collect(r, ref):
            dis = native.disambiguate(ref)
            cig_ops = np.fromiter((op for op, _ in r.cigar), np.int32,
                                  len(r.cigar))
            cig_lens = np.fromiter((ln for _, ln in r.cigar), np.int32,
                                   len(r.cigar))
            return dis, native.collect_meth_groups(
                dis, r.pos, cig_ops, cig_lens, r.is_reverse, len(r.seq),
                r.b2e_start, k)

        pool = self._host_pool(len(reads))
        if pool is not None:
            results = list(pool.map(_collect, reads, refs))
        else:
            results = [_collect(r, ref) for r, ref in zip(reads, refs)]
        ref_disamb = [d for d, _ in results]
        group_arrays = [g for _, g in results]
        self.stage_detail["hmm.collect_host"] += time.time() - t_col

        # flatten groups -> per-item arrays (2 items per group: unmeth, meth)
        n_groups_per_read = [g["start_pos"].shape[0] for g in group_arrays]
        total_g = int(sum(n_groups_per_read))
        if total_g == 0:
            return None
        g_read = np.repeat(np.arange(len(reads), dtype=np.int32),
                           n_groups_per_read)
        g_sub_start = np.concatenate([g["sub_start"] for g in group_arrays])
        g_sub_end = np.concatenate([g["sub_end"] for g in group_arrays])
        g_e1 = np.concatenate([g["e1"] for g in group_arrays])
        g_e2 = np.concatenate([g["e2"] for g in group_arrays])

        it_read = np.repeat(g_read, 2)
        it_sub_start = np.repeat(g_sub_start, 2)
        it_sub_end = np.repeat(g_sub_end, 2)
        it_e1 = np.repeat(g_e1, 2)
        it_e2 = np.repeat(g_e2, 2)
        it_meth = np.tile(np.array([0, 1], np.uint8), total_g)
        n_items = 2 * total_g

        # per-read device-input side arrays
        ref_off = np.zeros(len(reads), np.int64)
        np.cumsum([len(d) for d in ref_disamb][:-1], out=ref_off[1:])
        ref_concat = b"".join(ref_disamb)
        read_rc = np.array([1 if r.is_reverse else 0 for r in reads],
                           np.uint8)
        read_scale = np.array([r.scaling.scale for r in reads], np.float32)
        read_shift = np.array([r.scaling.shift for r in reads], np.float32)
        read_var = np.array([r.scaling.var for r in reads], np.float32)
        read_epb = np.array([r.events_per_base for r in reads], np.float32)

        lm_dev, ls_dev, ll_dev = self._cpg_dev_tables()

        sizes = np.abs(it_e2 - it_e1) + 1
        ksizes = (it_sub_end - it_sub_start + 1) - k + 1
        epb64 = read_epb.astype(np.float64)
        p_stay_rd = 1.0 - 1.0 / epb64
        from ..constants import HMM_P_BAD, HMM_P_SKIP

        rd_lp_stay = np.log(p_stay_rd).astype(np.float32)
        rd_lp_step = np.log(1.0 - p_stay_rd - HMM_P_SKIP
                            - HMM_P_BAD).astype(np.float32)
        it_ev_start = (ev_off[it_read] + it_e1).astype(np.int32)
        it_stride = np.where(it_e2 >= it_e1, 1, -1).astype(np.int32)
        it_n_ev = sizes.astype(np.int32)
        it_scale = read_scale[it_read]
        it_shift = read_shift[it_read]
        it_var = read_var[it_read]
        it_lp_stay = rd_lp_stay[it_read]
        it_lp_step = rd_lp_step[it_read]

        # compact device-side assembly (ops/hmm_meta.py): ship the 2-bit
        # packed reference + a per-read scalar table + 16 B of metadata
        # per window; ranks and all per-window arrays are rebuilt on
        # device, bit-identical to native hmm_window_ranks
        from ..ops.hmm_meta import hmm_forward_meta, pack_meta
        from ..ops.seq_ranks import pack_codes, seq_codes

        t_pk = time.time()
        codes = seq_codes(ref_concat + b"\0\0\0\0\0\0\0\0")
        packed_ref = pack_codes(codes, pad_to=1 << 12)
        n_rd = _bucket(len(reads), minimum=8)
        read_tab = np.zeros((n_rd, 8), np.float32)
        read_tab[:len(reads), 0] = read_scale
        read_tab[:len(reads), 1] = read_shift
        read_tab[:len(reads), 2] = read_var
        read_tab[:len(reads), 3] = rd_lp_stay
        read_tab[:len(reads), 4] = rd_lp_step
        read_tab[:len(reads), 5] = read_rc
        read_tab[len(reads):, 2] = 1.0   # var != 0 in padding
        it_gstart = (ref_off[it_read] + it_sub_start).astype(np.int32)
        it_wlen = (it_sub_end - it_sub_start + 1).astype(np.int32)
        self.stage_detail["hmm.pack_host"] += time.time() - t_pk
        self.stage_detail["hmm.h2d_bytes"] += (packed_ref.nbytes
                                               + read_tab.nbytes)
        devs = self._mesh_devices()
        if devs:
            from ..parallel.mesh import (data_mesh, put_replicated,
                                         put_sharded, record_dispatch,
                                         shard_hmm_forward)

            mesh = data_mesh(devs)
            m = self.cpg_model
            lm_dev, ls_dev, ll_dev = (
                put_replicated(mesh, t)
                for t in (m.level_mean, m.level_stdv, m.level_log_stdv))
            packed_ref_dev = put_replicated(mesh, packed_ref)
            read_tab_dev = put_replicated(mesh, read_tab)
        else:
            packed_ref_dev = jnp.asarray(packed_ref)
            read_tab_dev = jnp.asarray(read_tab)
        use_i16 = self.cpg_model.num_kmers <= 32767

        pending = []   # dispatch everything async; _meth_finish syncs
        order = np.argsort(sizes, kind="stable")
        # windows of <= 32 kmers (the vast majority) pack 4 per 128-lane
        # row (ops/hmm.hmm_forward_packed4); up to 128 kmers take a row
        for seg in (32, 128):
            if seg == 32:
                idxs = order[ksizes[order] <= 32]
            else:
                idxs = order[(ksizes[order] > 32)
                             & (ksizes[order] <= 128)]
            if not idxs.size:
                continue
            segs = 128 // seg
            n_sub = idxs.shape[0]
            n_rows = max(_nbucket(-(-n_sub // segs)), 8)
            t_pk = time.time()
            meta = np.zeros((n_rows * segs, 16), np.uint8)
            meta[:n_sub] = pack_meta(
                it_gstart[idxs], it_ev_start[idxs],
                it_stride[idxs] * it_n_ev[idxs], it_wlen[idxs],
                it_meth[idxs], it_read[idxs])
            pad_events = _ebucket(int(it_n_ev[idxs].max()))
            self.stage_detail["hmm.pack_host"] += time.time() - t_pk
            self.stage_detail["hmm.h2d_bytes"] += meta.nbytes
            t_disp = time.time()
            statics = dict(SEG=seg, k=k, use_i16=use_i16,
                           pad_events=pad_events)
            if devs and n_rows >= 2 * len(devs):
                # deal window-rows round-robin over the device mesh; the
                # event pool, packed reference and read table are
                # replicated (read-only)
                D = len(devs)
                n_rows_d = max(_nbucket(-(-n_rows // D)), 16)
                rows = meta.reshape(n_rows, segs * 16)
                dealt = np.zeros((D, n_rows_d, segs * 16), np.uint8)
                for d in range(D):
                    part = rows[d::D]
                    dealt[d, :part.shape[0]] = part
                record_dispatch(
                    "hmm_forward", dealt.nbytes,
                    packed_ref.nbytes + read_tab.nbytes
                    + int(ev_pool.nbytes)
                    + sum(t.nbytes for t in (m.level_mean, m.level_stdv,
                                             m.level_log_stdv)), D)
                ss = shard_hmm_forward(
                    mesh, put_sharded(mesh, dealt.reshape(
                        D, n_rows_d * segs, 16)),
                    packed_ref_dev, read_tab_dev, ev_pool,
                    lm_dev, ls_dev, ll_dev, **statics)
                # un-deal: row r's scores live at ss[r % D, r // D]
                s = jnp.transpose(ss, (1, 0, 2)).reshape(
                    D * n_rows_d, segs)[:n_rows]
            else:
                s = hmm_forward_meta(
                    jnp.asarray(meta), packed_ref_dev, read_tab_dev,
                    ev_pool, lm_dev, ls_dev, ll_dev, **statics)
            self.stage_detail["hmm.dispatch_enqueue"] += (time.time()
                                                          - t_disp)
            self.stage_detail["hmm.n_dispatch"] += 1
            s.copy_to_host_async()
            pending.append((idxs, n_sub, s))
        large = order[ksizes[order] > 128]
        if large.size:
            idxs = large
            pad_e = _bucket(int(sizes[idxs].max()), minimum=128)
            pad_k = _bucket(int(ksizes[idxs].max()), minimum=256)
            n_sub = idxs.shape[0]
            n_pad = _nbucket(n_sub)
            ranks, n_km = native.hmm_window_ranks(
                n_sub, n_pad, pad_k, k, ref_concat, ref_off,
                it_read[idxs], it_sub_start[idxs], it_sub_end[idxs],
                it_meth[idxs], read_rc, self.cpg_model.num_kmers)

            def _pad1(a, fill=0, idxs=idxs, n_pad=n_pad):
                out = np.full(n_pad, fill, dtype=a.dtype)
                out[:idxs.shape[0]] = a[idxs]
                return out

            t_disp = time.time()
            s = hmm_forward_packed(
                jnp.asarray(ranks), jnp.asarray(n_km), ev_pool,
                jnp.asarray(_pad1(it_ev_start)),
                jnp.asarray(_pad1(it_stride, fill=1)),
                jnp.asarray(_pad1(it_n_ev)),
                jnp.asarray(_pad1(it_scale, fill=1)),
                jnp.asarray(_pad1(it_shift)),
                jnp.asarray(_pad1(it_var, fill=1)),
                jnp.asarray(_pad1(it_lp_stay)),
                jnp.asarray(_pad1(it_lp_step)),
                lm_dev, ls_dev, ll_dev, pad_events=pad_e)
            self.stage_detail["hmm.dispatch_enqueue"] += (time.time()
                                                          - t_disp)
            self.stage_detail["hmm.n_dispatch"] += 1
            try:
                s.copy_to_host_async()
            except AttributeError:
                pass
            pending.append((idxs, n_sub, s))
        for *_ , s in pending:
            try:
                s.copy_to_host_async()
            except AttributeError:
                pass
        return (reads, group_arrays, ref_disamb, n_items, pending)

    def _meth_finish(self, states):
        """Sync the dispatched HMM scores and keep them per read as
        struct-of-arrays (MethCalls) in batch order — the per-site
        ScoredSite loop this replaces cost ~0.3 s of host time per
        42k-site batch; rendering happens natively on the writer
        thread (_render_meth_rows)."""
        from .methylation import MethCalls

        t0 = time.time()
        k = self.cpg_model.k
        out_sites: dict[int, MethCalls] = {}
        for reads, group_arrays, ref_disamb, n_items, pending in states:
            scores = np.zeros(n_items, dtype=np.float32)
            t_sync = time.time()
            for idxs, n_sub, s in pending:
                scores[idxs] = np.asarray(s).reshape(-1)[:n_sub]
            # wait for device HMM compute + score D2H not overlapped by
            # host work
            t_assemble = time.time()
            self.stage_detail["hmm.score_sync"] += t_assemble - t_sync
            gi = 0
            for ri, r in enumerate(reads):
                g = group_arrays[ri]
                n_g = g["start_pos"].shape[0]
                out_sites[id(r)] = MethCalls(
                    starts=g["start_pos"], ends=g["end_pos"],
                    n_cpg=g["n_cpg"],
                    llu=scores[2 * gi:2 * (gi + n_g):2].copy(),
                    llm=scores[2 * gi + 1:2 * (gi + n_g):2].copy(),
                    dis=ref_disamb[ri], r_pos=r.pos, k=k)
                gi += n_g
            self.stage_detail["hmm.assemble_host"] += (time.time()
                                                       - t_assemble)
        self.stage_time["hmm"] += time.time() - t0
        return out_sites

    def _cpg_dev_tables(self):
        """Device-resident CpG model tables (cached)."""
        if not hasattr(self, "_cpg_dev"):
            import jax.numpy as jnp

            m = self.cpg_model
            self._cpg_dev = (jnp.asarray(m.level_mean),
                             jnp.asarray(m.level_stdv),
                             jnp.asarray(m.level_log_stdv))
        return self._cpg_dev

    def _fetch_ref_segment(self, r: ReadRecord) -> str:
        from ..io.bam import BamRecord

        ref_name = self.bam.references[r.tid]
        end = r.pos
        for op, ln in r.cigar:
            if op in (0, 2, 3, 7, 8):
                end += ln
        return self.genome.fetch(ref_name, r.pos, end)

    def batches_prefetched(self, keep_raw: bool = False, depth: int = 2):
        """batches() behind a prefetch thread: batch N+1 loads (signal
        fetch + event detection, IO/native-bound) while the device
        processes batch N — the reference's 3-stage interleaved pipeline
        (meth_main.c:610-742) collapsed to load/process overlap."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=depth)
        _END = object()

        def worker():
            try:
                for b in self.batches(keep_raw=keep_raw):
                    q.put(b)
                q.put(_END)
            except BaseException as e:  # surface loader errors in-line
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()

    # ---- stage-level debug dumps (reference --print-* oracles) -----------
    def debug_prints(self, batch, out=sys.stdout):
        """--print-events / --print-banded-aln / --print-scaling in the
        reference's exact formats (f5c.c:974-1021)."""
        opt = self.opt
        if opt.print_events:
            for r in batch:
                if r.event_means is None:
                    continue
                n = r.event_starts.shape[0]
                start = int(r.event_starts[0]) if n else 0
                end = (int(r.event_starts[-1] + r.event_lengths[-1])
                       if n else 0)
                out.write(f">{r.qname}\tLN:{n}\tEVENTSTART:{start}\t"
                          f"EVENTEND:{end}\n")
                out.write("\t".join(
                    f"{{{int(r.event_starts[j])},{r.event_lengths[j]:f},"
                    f"{r.event_means[j]:f},{r.event_stdvs[j]:f}}}"
                    for j in range(n)) + "\t\n")
        if opt.print_banded_aln:
            for r in batch:
                if r.status & FAILED_ALIGNMENT or r.pairs is None:
                    continue
                out.write(f">{r.qname}\tN_ALGN_PAIR:{r.pairs.shape[0]}\t"
                          "{ref_pos,read_pos}\n")
                out.write("\t".join(
                    f"{{{int(k)},{int(e)}}}" for k, e in r.pairs) + "\t\n")
        if opt.print_scaling:
            out.write("read\tshift\tscale\tvar\n")
            for r in batch:
                if r.status & (FAILED_ALIGNMENT | FAILED_CALIBRATION) \
                        or r.scaling is None:
                    continue
                out.write(f"{r.qname}\t{r.scaling.shift:.2f}\t"
                          f"{r.scaling.scale:.2f}\t{r.scaling.var:.2f}\n")

    # ---- tool drivers ----------------------------------------------------
    def call_methylation(self, out=sys.stdout):
        if self.cpg_model is None:
            raise RuntimeError(
                "--pore r10 needs an explicit CpG model for "
                "call-methylation: pass --meth-model <file> (9-mer ACGMT "
                "table; convert with scripts/convert_models.py)")
        opt = self.opt
        if opt.meth_out_version == 1:
            out.write("chromosome\tstart\tend\tread_name\t"
                      "log_lik_ratio\tlog_lik_methylated\t"
                      "log_lik_unmethylated\tnum_calling_strands\t"
                      "num_cpgs\tsequence\n")
        else:
            out.write("chromosome\tstrand\tstart\tend\tread_name\t"
                      "log_lik_ratio\tlog_lik_methylated\t"
                      "log_lik_unmethylated\tnum_calling_strands\t"
                      "num_motifs\tsequence\n")
        from .writer import AsyncWriter

        # rows render + write on the post-processor thread
        # (meth_main.c:610-742's output thread), overlapping the next
        # batch's compute
        writer = AsyncWriter(out)
        use_waves = self.supports_waves()
        batches = (self.batches(load=False) if use_waves
                   else self.batches_prefetched())
        try:
            for batch in batches:
                if use_waves:
                    self.align_batch_waved(batch, meth_inline=True)
                else:
                    self.align_batch(batch)
                sites_by_read = self.meth_batch(batch)
                if (opt.print_events or opt.print_banded_aln
                        or opt.print_scaling):
                    import io as _io

                    dbg = _io.StringIO()
                    self.debug_prints(batch, dbg)
                    writer.write(dbg.getvalue())
                t0 = time.time()
                for r in batch:
                    if r.status:
                        self._count_failure(r)
                        continue
                    self.counters["processed"] += 1
                    tg = time.time()
                    site_map = sites_by_read.get(id(r), {})
                    # a lazy get may sync HMM scores (counted under
                    # "hmm" by _meth_finish); exclude it from "output"
                    t0 += time.time() - tg
                    if not site_map:
                        continue
                    contig = self.bam.references[r.tid]
                    if opt.dist_markers:
                        from ..parallel.distributed import MARKER
                        writer.write(f"{MARKER}{r.read_idx}\n")
                    writer.write_lazy(functools.partial(
                        _render_meth_rows, contig, r.qname, r.is_reverse,
                        site_map, opt.meth_out_version,
                        self.clip_start, self.clip_end))
                self.stage_time["output"] += time.time() - t0
        finally:
            t0 = time.time()
            writer.close()
            self.stage_time["output"] += time.time() - t0

    def _count_failure(self, r: ReadRecord):
        if r.status & FAILED_CALIBRATION:
            self.counters["failed_calibration"] += 1
        elif r.status & FAILED_ALIGNMENT:
            self.counters["failed_alignment"] += 1
        elif r.status & FAILED_QUALITY_CHK:
            self.counters["qc_fail"] += 1

    def report(self, f=None):
        """End-of-run counters + sanity warnings (meth_main.c:744-837).
        Returns a nonzero exit code when every read failed."""
        f = f or sys.stderr
        c = self.counters
        f.write(f"[f5c-tpu] candidate reads: {c['total_reads']}; "
                f"processed: {c['processed']}; "
                f"skipped mapq<{self.opt.min_mapq}: {c['low_mapq']}; "
                f"secondary: {c['secondary']}; unmapped: {c['unmapped']}; "
                f"bad signal: {c['bad_signal']}; "
                f"ultra-long skipped: {c['ultra_long_skipped']}\n")
        f.write(f"[f5c-tpu] failed: calibration {c['failed_calibration']}, "
                f"alignment {c['failed_alignment']}, qc {c['qc_fail']}\n")
        st = self.stage_time
        f.write("[f5c-tpu] stage seconds: "
                + " ".join(f"{k}={v:.2f}" for k, v in st.items()) + "\n")
        f.write("[f5c-tpu] engines: " + " ".join(
            f"{k}={v}" for k, v in sorted(self.engines.items())) + "\n")
        if self.opt.profile_detail and self.stage_detail:
            # --profile-cpu=yes analogue: per-component breakdown
            # (host compute vs transfer bytes vs dispatch counts)
            f.write("[f5c-tpu] stage detail: " + " ".join(
                f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in sorted(self.stage_detail.items())) + "\n")
        # perf advisors (the reference's load/memory balancers print
        # actionable -K/-B/--cuda-* hints after repeated imbalance,
        # f5c.cu:457-644; here: dispatch amortisation and the device
        # trace budget)
        n_batches = getattr(self, "_n_batches", 0)
        if (c["processed"] > 0 and n_batches > 0
                and c["processed"] / n_batches < 64
                and c["processed"] >= 64):
            f.write("[f5c-tpu] hint: batches average "
                    f"{c['processed'] // n_batches} reads; device "
                    "dispatch latency amortises poorly below ~64 "
                    "reads/batch — increase -K/-B if memory allows.\n")
        if getattr(self, "_trace_budget_splits", 0) > 0:
            f.write("[f5c-tpu] hint: the ABEA trace budget split "
                    f"{self._trace_budget_splits} sub-batches; raise "
                    "F5C_TPU_TRACE_BYTES (device HBM permitting) or "
                    "lower -B to avoid padding waste.\n")
        failed = (c["failed_calibration"] + c["failed_alignment"]
                  + c["qc_fail"])
        total = c["total_reads"]
        if total > 0 and failed == total:
            f.write("[f5c-tpu] ERROR: all reads failed. Check that --pore "
                    "and --rna match the dataset chemistry.\n")
            return 1
        if total > 0 and failed > total * 0.5:
            f.write("[f5c-tpu] WARNING: more than half of the reads "
                    "failed. Check --pore / --rna against the dataset "
                    "chemistry (meth_main.c:821-837).\n")
        return 0


class _LazySites:
    """Per-state lazy view of the wave pipeline's meth scores: a read's
    sites finalize (score sync + MethCalls assembly) on first access,
    so the tail waves' HMM device time is paid only when a read that
    needs it is emitted — by which point the writer thread is already
    rendering the earlier waves' rows."""

    def __init__(self, pipe, states, extra):
        self._pipe = pipe
        self._states = states
        self._done = dict(extra)
        self._owner = {}
        for si, st in enumerate(states):
            for r in st[0]:
                self._owner[id(r)] = si
        self._final = [False] * len(states)

    def get(self, rid, default=None):
        if rid in self._done:
            return self._done[rid]
        si = self._owner.get(rid)
        if si is None or self._final[si]:
            return default
        self._done.update(self._pipe._meth_finish([self._states[si]]))
        self._final[si] = True
        self._states[si] = None
        return self._done.get(rid, default)


def _render_meth_rows(contig: str, qname: str, is_reverse: bool,
                      site_map, out_version: int,
                      clip_start: int, clip_end: int):
    """One read's methylation TSV rows (f5c.c:1030-1062 format)."""
    from .. import native
    from .methylation import MethCalls

    if isinstance(site_map, MethCalls):
        mc = site_map
        if native.available():
            starts = np.asarray(mc.starts)
            ends = np.asarray(mc.ends)
            ncpg = np.asarray(mc.n_cpg)
            llu, llm = mc.llu, mc.llm
            if clip_start != -1 or clip_end != -1:
                keep = np.ones(starts.shape[0], bool)
                if clip_start != -1:
                    keep &= starts >= clip_start
                if clip_end != -1:
                    keep &= ends < clip_end
                if not keep.all():
                    starts, ends, ncpg = (starts[keep], ends[keep],
                                          ncpg[keep])
                    llu, llm = llu[keep], llm[keep]
            if starts.shape[0] == 0:
                return b""
            strand = (0 if out_version == 1
                      else ord("-") if is_reverse else ord("+"))
            seq_start = starts - mc.r_pos - (mc.k - 1)
            seq_end = ends - mc.r_pos + mc.k
            return native.format_meth_rows_soa(
                contig, qname, strand, starts, ends, llm, llu, ncpg,
                mc.dis, seq_start, seq_end)
        site_map = mc.to_sites()
    sites = [site_map[s] for s in sorted(site_map)
             # window clip (f5c.c:1046-1047)
             if not ((clip_start != -1
                      and site_map[s].start_position < clip_start)
                     or (clip_end != -1
                         and site_map[s].end_position >= clip_end))]
    if not sites:
        return b""
    if native.available():
        strand = (0 if out_version == 1
                  else ord("-") if is_reverse else ord("+"))
        return native.format_meth_rows(
            contig, qname, strand,
            [ss.start_position for ss in sites],
            [ss.end_position for ss in sites],
            [ss.ll_methylated for ss in sites],
            [ss.ll_unmethylated for ss in sites],
            [ss.strands_scored for ss in sites],
            [ss.n_cpg for ss in sites],
            [ss.sequence for ss in sites])
    parts = []
    for ss in sites:
        if out_version == 1:
            head = f"{contig}\t{ss.start_position}\t{ss.end_position}\t"
        else:
            strand = "-" if is_reverse else "+"
            head = (f"{contig}\t{strand}\t{ss.start_position}"
                    f"\t{ss.end_position}\t")
        parts.append(f"{head}{qname}\t{ss.llr:.2f}\t"
                     f"{ss.ll_methylated:.2f}\t"
                     f"{ss.ll_unmethylated:.2f}\t"
                     f"{ss.strands_scored}\t{ss.n_cpg}\t"
                     f"{ss.sequence}\n")
    return "".join(parts)


def parse_regions(region_str: str):
    """-w argument: 'chr:start-end', bare 'chr', or a .bed file of
    regions (meth_main.c:484).  Returns [(chrom, start, end)]."""
    import os

    def parse_one(s: str):
        if ":" in s:
            chrom, rng = s.rsplit(":", 1)
            if "-" in rng:
                a, b = rng.split("-")
                return (chrom, int(a.replace(",", "")),
                        int(b.replace(",", "")))
            return (chrom, int(rng.replace(",", "")), 1 << 62)
        return (s, 0, 1 << 62)

    if os.path.isfile(region_str) and region_str.endswith(".bed"):
        out = []
        with open(region_str) as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) >= 3 and not line.startswith("#"):
                    out.append((cols[0], int(cols[1]), int(cols[2])))
        return out
    return [parse_one(region_str)]


def detect_pore_from_slow5(path: str):
    """Chemistry autodetect from the SLOW5 header (f5c.c:91-142
    drna_detect/pore_detect): experiment_type == 'rna' -> RNA;
    sequencing_kit containing '114' -> R10, 'rna004' -> RNA004.
    Returns (rna or None, pore or None)."""
    from ..io.slow5 import Slow5File

    try:
        f = Slow5File(path, create_index_if_missing=False)
    except (OSError, AssertionError):
        return None, None
    attrs = f.header.attrs
    f.close()
    rna = None
    pore = None
    exp = [v for v in attrs.get("experiment_type", []) if v]
    if exp:
        rna = all(v == "rna" for v in exp)
    kits = [v for v in attrs.get("sequencing_kit", []) if v]
    if kits:
        if any("114" in v for v in kits):
            pore = "r10"
        if any("rna004" in v for v in kits):
            pore = "rna004"
    return rna, pore


def _bucket(n: int, minimum: int = 256) -> int:
    """Round up to the next power of two (>= minimum) to bound recompiles."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _pool_bucket(n: int) -> int:
    """Event-pool length bucket: powers of two up to 1M, then 256k
    granularity (bounded padding for large pools)."""
    if n > (1 << 20):
        return ((n + (1 << 18) - 1) >> 18) << 18
    return _bucket(n, minimum=1 << 16)


def _ebucket(n: int) -> int:
    """HMM event-window row bucket: 32-step granularity up to 128 (most
    CpG windows are ~30-60 events; dispatches are async and synced once
    per batch, so the extra buckets cost no round trips), powers of two
    beyond."""
    if n <= 128:
        return 32 * ((n + 31) // 32)
    return _bucket(n, minimum=256)


def _nbucket(n: int) -> int:
    """Batch-count bucket: powers of two up to 8192, then multiples of
    8192 — bounds both recompiles and padding waste for large item
    counts."""
    if n <= 8192:
        return _bucket(n, minimum=256)
    return ((n + 8191) // 8192) * 8192
