"""meth-freq / freq-merge: aggregate per-read calls into per-site
methylation frequencies (reference src/freq.c, src/freq_merge.c).

Two engines produce byte-identical tables:
- native (default for file-backed input): the C++ accumulator in
  f5chost.cpp streams the TSV in 8 MB chunks — this repo's analogue of
  the reference's C implementation (production meth TSVs are GBs).
  Lines its strict parser is unsure about (anything CPython's
  int()/float() might read differently) are handed back and re-processed
  here with exact Python semantics, including the located
  malformed-line error.
- python (StringIO/iterator input, or F5C_TPU_FREQ_ENGINE=python): the
  plain per-line loop below, which doubles as the native engine's
  oracle (tests/test_pipeline.py::test_meth_freq_native_engine).
"""

from __future__ import annotations

import io
import os
import sys
from dataclasses import dataclass, field


@dataclass
class SiteStats:
    group_size: int
    sequence: str
    num_reads: int = 0
    called_sites: int = 0
    called_sites_methylated: int = 0


HEADERS = {
    ("chromosome\tstart\tend\tread_name\tlog_lik_ratio\t"
     "log_lik_methylated\tlog_lik_unmethylated\tnum_calling_strands\t"
     "num_cpgs\tsequence"): (1, "cpgs"),
    ("chromosome\tstart\tend\tread_name\tlog_lik_ratio\t"
     "log_lik_methylated\tlog_lik_unmethylated\tnum_calling_strands\t"
     "num_motifs\tsequence"): (1, "motifs"),
    ("chromosome\tstrand\tstart\tend\tread_name\tlog_lik_ratio\t"
     "log_lik_methylated\tlog_lik_unmethylated\tnum_calling_strands\t"
     "num_cpgs\tsequence"): (2, "cpgs"),
    ("chromosome\tstrand\tstart\tend\tread_name\tlog_lik_ratio\t"
     "log_lik_methylated\tlog_lik_unmethylated\tnum_calling_strands\t"
     "num_motifs\tsequence"): (2, "motifs"),
}


def meth_freq(lines, call_threshold: float = 2.5, split_groups: bool = False,
              out=sys.stdout):
    """Aggregate a call-methylation TSV stream into site frequencies."""
    engine = os.environ.get("F5C_TPU_FREQ_ENGINE", "auto")
    stream = getattr(lines, "buffer", None)
    if engine != "python":
        if stream is not None:
            from .. import native

            if native.available():
                return _meth_freq_native(stream, call_threshold,
                                         split_groups, out)
            if engine == "native":
                raise RuntimeError("F5C_TPU_FREQ_ENGINE=native but the "
                                   "native library is unavailable")
        elif engine == "native":
            raise ValueError("the native freq engine needs a file-backed "
                             "stream (open the TSV as a file)")
    it = iter(lines)
    header = next(it).rstrip("\n")
    if header not in HEADERS:
        raise ValueError(f"unrecognised header: {header!r}")
    version, motif_word = HEADERS[header]
    sites: dict[tuple, SiteStats] = {}

    for lineno, line in enumerate(it, start=2):
        if not line.strip():
            continue
        cols = line.rstrip("\n").split("\t")
        try:
            if version == 2:
                chrom = cols[0]
                start_i, end_i = int(cols[2]), int(cols[3])
                llr = float(cols[5])
                num_sites = int(cols[9])
                sequence = cols[10]
            else:
                chrom = cols[0]
                start_i, end_i = int(cols[1]), int(cols[2])
                llr = float(cols[4])
                num_sites = int(cols[8])
                sequence = cols[9]
        except (IndexError, ValueError) as e:
            raise ValueError(
                f"malformed call-methylation TSV at line {lineno} "
                f"({len(cols)} fields): {line[:80]!r}") from e
        if abs(llr) < call_threshold:
            continue
        is_meth = llr > 0
        if split_groups and num_sites > 1:
            first_cg = sequence.find("CG")
            pos = first_cg
            while pos != -1:
                key = (chrom, start_i + pos - first_cg, start_i + pos - first_cg)
                ss = sites.setdefault(key, SiteStats(1, "split-group"))
                ss.num_reads += 1
                ss.called_sites += 1
                if is_meth:
                    ss.called_sites_methylated += 1
                pos = sequence.find("CG", pos + 1)
        else:
            key = (chrom, start_i, end_i)
            ss = sites.setdefault(key, SiteStats(num_sites, sequence))
            ss.num_reads += 1
            ss.called_sites += num_sites
            if is_meth:
                ss.called_sites_methylated += num_sites

    out.write(f"chromosome\tstart\tend\tnum_{motif_word}_in_group\t"
              "called_sites\tcalled_sites_methylated\t"
              "methylated_frequency\tgroup_sequence\n")
    for key in sorted(sites):
        chrom, start, end = key
        ss = sites[key]
        if ss.called_sites > 0:
            f = ss.called_sites_methylated / ss.called_sites
            out.write(f"{chrom}\t{start}\t{end}\t{ss.group_size}\t"
                      f"{ss.called_sites}\t{ss.called_sites_methylated}\t"
                      f"{f:.3f}\t{ss.sequence}\n")


def _line_updates(line: str, lineno: int, version: int,
                  call_threshold: float, split_groups: bool):
    """Exact per-line semantics of the Python loop above, expressed as a
    list of (chrom, start, end, group_size, seq, called_inc, meth_inc)
    site updates — applied to the native accumulator for lines its
    strict parser handed back."""
    if not line.strip():
        return []
    cols = line.rstrip("\n").split("\t")
    try:
        if version == 2:
            chrom = cols[0]
            start_i, end_i = int(cols[2]), int(cols[3])
            llr = float(cols[5])
            num_sites = int(cols[9])
            sequence = cols[10]
        else:
            chrom = cols[0]
            start_i, end_i = int(cols[1]), int(cols[2])
            llr = float(cols[4])
            num_sites = int(cols[8])
            sequence = cols[9]
    except (IndexError, ValueError) as e:
        raise ValueError(
            f"malformed call-methylation TSV at line {lineno} "
            f"({len(cols)} fields): {(line + chr(10))[:80]!r}") from e
    if abs(llr) < call_threshold:
        return []
    is_meth = llr > 0
    if split_groups and num_sites > 1:
        ups = []
        first_cg = sequence.find("CG")
        pos = first_cg
        while pos != -1:
            p = start_i + pos - first_cg
            ups.append((chrom, p, p, 1, "split-group", 1,
                        1 if is_meth else 0))
            pos = sequence.find("CG", pos + 1)
        return ups
    return [(chrom, start_i, end_i, num_sites, sequence, num_sites,
             num_sites if is_meth else 0)]


def _meth_freq_native(stream, call_threshold: float, split_groups: bool,
                      out):
    """Drive the C++ accumulator over a binary stream (f5chost.cpp
    f5c_freq_*).  Output is byte-identical to the Python engine; '\\r\\n'
    line endings are normalised like Python text mode (lone-'\\r' line
    breaks are not — the reference's C reader doesn't split them
    either)."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    header = stream.readline().decode().rstrip("\r\n")
    if header not in HEADERS:
        raise ValueError(f"unrecognised header: {header!r}")
    version, motif_word = HEADERS[header]
    st = lib.f5c_freq_new(version, 1 if split_groups else 0,
                          float(call_threshold))
    try:
        rem = b""
        while True:
            chunk = stream.read(8 << 20)
            if not chunk:
                break
            if rem:
                chunk = rem + chunk
            consumed = lib.f5c_freq_accumulate(st, chunk, len(chunk))
            rem = chunk[consumed:]
        if rem:                       # final line without a newline
            rem += b"\n"
            lib.f5c_freq_accumulate(st, rem, len(rem))

        data_p = ctypes.c_void_p()
        dlen = ctypes.c_int64()
        lin_p = ctypes.c_void_p()
        n_rej = lib.f5c_freq_rejects(st, ctypes.byref(data_p),
                                     ctypes.byref(dlen),
                                     ctypes.byref(lin_p))
        if n_rej:
            text = ctypes.string_at(data_p.value, dlen.value).decode()
            linenos = ctypes.cast(
                lin_p.value, ctypes.POINTER(ctypes.c_int64))
            for i, line in enumerate(text.split("\n")[:-1]):
                for (chrom, s, e, gsz, seq, c_inc, m_inc) in _line_updates(
                        line, linenos[i], version, call_threshold,
                        split_groups):
                    cb = chrom.encode()
                    sb = seq.encode()
                    lib.f5c_freq_update(st, cb, len(cb), s, e, gsz,
                                        sb, len(sb), c_inc, m_inc)

        obuf = ctypes.c_void_p()
        olen = lib.f5c_freq_emit(st, motif_word.encode(),
                                 ctypes.byref(obuf))
        out.write(ctypes.string_at(obuf.value, olen).decode())
    finally:
        lib.f5c_freq_free(st)


def freq_merge(paths: list[str], out=sys.stdout):
    """k-way merge of sorted meth-freq TSVs, summing counts per site
    (reference src/freq_merge.c).

    File-descriptor outputs stream through the native C++ merge
    (f5chost.cpp f5c_freq_merge, ~10x the Python loop) — byte-identical
    pick-smallest-head semantics, ties to the lowest file index, only
    the called/methylated/frequency columns rewritten.  StringIO outputs
    (or F5C_TPU_FREQ_ENGINE=python) use the Python loop below, which is
    the native engine's oracle."""
    engine = os.environ.get("F5C_TPU_FREQ_ENGINE", "auto")
    if engine != "python" and hasattr(out, "fileno"):
        from .. import native

        if native.available():
            try:
                fd = out.fileno()
            except (OSError, ValueError, io.UnsupportedOperation):
                fd = None
            if fd is not None:
                return _freq_merge_native(paths, out, fd)
        if engine == "native":
            raise RuntimeError("F5C_TPU_FREQ_ENGINE=native but the "
                               "native library is unavailable")
    import heapq

    files = [open(p) for p in paths]
    headers = [f.readline().rstrip("\n") for f in files]
    if len(set(headers)) != 1:
        raise ValueError("input files have differing headers")
    out.write(headers[0] + "\n")

    def rows(f):
        for lineno, line in enumerate(f, start=2):
            if not line.strip():
                continue
            c = line.rstrip("\n").split("\t")
            try:
                if len(c) < 8:
                    raise IndexError(f"{len(c)} fields, expected 8")
                yield (c[0], int(c[1]), int(c[2])), c
            except (IndexError, ValueError) as e:
                raise ValueError(
                    f"malformed frequency TSV line {lineno} in "
                    f"{getattr(f, 'name', '<stream>')}: {line[:80]!r}"
                ) from e

    merged = heapq.merge(*(rows(f) for f in files), key=lambda x: x[0])
    pending_key = None
    pend = None
    for key, c in merged:
        if key == pending_key:
            pend[4] = str(int(pend[4]) + int(c[4]))
            pend[5] = str(int(pend[5]) + int(c[5]))
        else:
            if pend is not None:
                _emit_freq_row(pend, out)
            pending_key, pend = key, list(c)
    if pend is not None:
        _emit_freq_row(pend, out)
    for f in files:
        f.close()


def _freq_merge_native(paths: list[str], out, fd: int):
    """Stream the native k-way merge into out's file descriptor."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    out.flush()
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    ef = ctypes.c_int64(-1)
    el = ctypes.c_int64(-1)
    rc = lib.f5c_freq_merge(arr, len(paths), fd,
                            ctypes.byref(ef), ctypes.byref(el))
    if rc == 0:
        return
    if rc == 1:
        raise ValueError("input files have differing headers")
    if rc == 2:
        name = paths[ef.value]
        line = ""
        with open(name) as f:
            for i, text in enumerate(f, start=1):
                if i == el.value:
                    line = text
                    break
        raise ValueError(
            f"malformed frequency TSV line {el.value} in {name}: "
            f"{line[:80]!r}")
    bad = paths[ef.value] if 0 <= ef.value < len(paths) else "<output>"
    raise OSError(f"freq-merge: cannot open/read {bad}")


def _emit_freq_row(c, out):
    called = int(c[4])
    meth = int(c[5])
    c[6] = f"{meth / called:.3f}" if called else "0.000"
    out.write("\t".join(c) + "\n")
