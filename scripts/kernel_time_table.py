#!/usr/bin/env python3
"""Device-time tables from a JAX profiler trace of the GPU.

``device_tables(trace_dir)`` reads the newest ``*.xplane.pb`` under
``trace_dir`` with ``jax.profiler.ProfileData`` and, for the first GPU
(plane ``/device:GPU:0``), sums the durations of the events on its
``Stream #...`` lines (CUDA kernels and copies)

- per jitted program (each event's ``hlo_module`` stat:
  ``jit_abea_align_cuda``, ``jit_hmm_forward_meta``, ...),
- per kernel (the event name),

and the device busy share: the union of the stream events' intervals
over the span from the first to the last of them.

Run as a script, it traces one warm call-methylation run of bench.py's
generated dataset and prints the tables:

    python scripts/kernel_time_table.py [--reads=N] [trace_dir]
"""

import glob
import os
import shutil
import subprocess
import sys
import tempfile
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_tables(trace_dir, device="/device:GPU:0"):
    """Returns (modules {name: (seconds, count)}, kernels {name:
    (seconds, count)}, busy seconds, window seconds)."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise SystemExit(f"no .xplane.pb under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(max(paths,
                                                key=os.path.getmtime))
    planes = {p.name: p for p in pd.planes}
    if device not in planes:
        raise SystemExit(f"no plane {device} in the trace (planes: "
                         f"{sorted(planes)}): not a GPU trace")
    modules = defaultdict(lambda: [0.0, 0])
    kernels = defaultdict(lambda: [0.0, 0])
    intervals = []
    for line in planes[device].lines:
        if not line.name.startswith("Stream"):
            continue
        for e in line.events:
            sec = e.duration_ns / 1e9
            module = dict(e.stats).get("hlo_module", "(no module)")
            for table, key in ((modules, module), (kernels, e.name)):
                table[key][0] += sec
                table[key][1] += 1
            intervals.append((e.start_ns, e.start_ns + e.duration_ns))
    if not intervals:
        raise SystemExit(f"no stream events on {device}: the trace format "
                         "changed; refusing to print an empty table")
    window = (max(e for _, e in intervals)
              - min(s for s, _ in intervals)) / 1e9
    busy = _union_ns(intervals) / 1e9
    return ({k: tuple(v) for k, v in modules.items()},
            {k: tuple(v) for k, v in kernels.items()}, busy, window)


def print_tables(modules, kernels, busy, window, top=20, out=sys.stdout):
    for title, table in (("program", modules), ("kernel", kernels)):
        print(f"{'device s':>10} {'calls':>6}  {title}", file=out)
        for name, (sec, n) in sorted(table.items(),
                                     key=lambda kv: -kv[1][0])[:top]:
            print(f"{sec:10.4f} {n:6d}  {name[:90]}", file=out)
    print(f"device busy {busy:.4f} s of a {window:.4f} s window: idle "
          f"share {1 - busy / max(window, 1e-12):.3f}", file=out)


def main():
    import jax

    import bench

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n_reads = int(bench._arg("reads", 1024))
    tmp = tempfile.mkdtemp(prefix="f5c_ktt_")
    trace_dir = args[0] if args else os.path.join(tmp, "trace")
    try:
        bam, genome, reads, _, slow5 = bench.setup_dataset(
            tmp, n_reads=n_reads)
        out = os.path.join(tmp, "o.tsv")
        for _ in range(2):          # compile + first-call costs
            bench.run_once(bam, genome, reads, out, slow5)
        with jax.profiler.trace(trace_dir):
            wall, pipe = bench.run_once(bam, genome, reads, out, slow5)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip() or jax.devices()[0].device_kind
        print(f"[ktt] traced wall {wall:.3f} s "
              f"({pipe.counters['processed']} reads) on {card}")
        print_tables(*device_tables(trace_dir))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
