#!/usr/bin/env python3
"""End-to-end A/B of the two ABEA routes on the GPU: the CUDA kernel
(ops/abea_cuda.py) against what XLA makes of the plain version
(ops/abea.abea_align_xla).

Generates the real-size dataset from ``--seed`` (f5c_tpu/sim.py), then
runs call-methylation through the CLI in this process at f5c's defaults
(-K 512 -B 2M), swapping ``ops.route.abea_impl`` between runs: one
warm-up per route, then timed runs in the order kernel, XLA, XLA,
kernel.  Finally one warm run of each route under the JAX profiler gives
the device time per jitted program (ABEA vs the HMM scorer) and the
device idle share (scripts/kernel_time_table.py).

    python scripts/abea_route_ab.py [--seed=N] [--reads=N]
"""

import contextlib
import io
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))


def main():
    import jax

    import bench
    from kernel_time_table import device_tables, print_tables

    from f5c_tpu.cli import main as cli
    from f5c_tpu.ops import abea, abea_cuda, route

    if jax.default_backend() != "gpu":
        raise SystemExit("abea_route_ab: needs the GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[ab] card: {card}", flush=True)
    abea_cuda.load()
    routes = {"kernel": abea_cuda.abea_align_cuda,
              "xla": abea.abea_align_xla}
    tmp = tempfile.mkdtemp(prefix="f5c_ab_")
    try:
        bam, genome, reads, n_reads, slow5 = bench.setup_dataset(
            tmp, seed=int(bench._arg("seed", 1)),
            n_reads=int(bench._arg("reads", 1024)))
        argv = ["call-methylation", "-b", bam, "-g", genome, "-r", reads,
                "--slow5", slow5, "-K", "512", "-B", "2M"]
        outs = {}

        def run(name, trace_dir=None):
            route.abea_impl = lambda: routes[name]
            out = os.path.join(tmp, f"{name}.tsv")
            err = io.StringIO()
            ctx = (jax.profiler.trace(trace_dir) if trace_dir
                   else contextlib.nullcontext())
            t0 = time.perf_counter()
            with ctx, contextlib.redirect_stderr(err):
                rc = cli([*argv, "-o", out])
            wall = time.perf_counter() - t0
            assert rc == 0, err.getvalue()[-2000:]
            stages = [ln for ln in err.getvalue().splitlines()
                      if "stage seconds" in ln]
            with open(out) as f:
                outs[name] = f.read()
            return wall, stages[-1] if stages else ""

        for name in ("kernel", "xla"):
            wall, stages = run(name)
            print(f"[ab] warm-up {name}: {wall:.3f} s  {stages}",
                  flush=True)
        for name in ("kernel", "xla", "xla", "kernel"):
            wall, stages = run(name)
            print(f"[ab] {name}: wall {wall:.3f} s, "
                  f"{n_reads / wall:.2f} reads/s  {stages}", flush=True)
        same = outs["kernel"] == outs["xla"]
        print(f"[ab] call-methylation TSV identical across routes: {same}")
        for name in ("kernel", "xla"):
            trace_dir = os.path.join(tmp, f"trace_{name}")
            wall, _ = run(name, trace_dir)
            print(f"[ab] traced {name} run: wall {wall:.3f} s")
            print_tables(*device_tables(trace_dir), top=12)
            sys.stdout.flush()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
