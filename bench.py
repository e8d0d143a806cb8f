#!/usr/bin/env python3
"""Benchmark: call-methylation (or eventalign) throughput on a generated
genome-mapped dataset.

Runs the full pipeline (signal load -> events -> ABEA -> recalibration ->
profile HMM -> TSV) on the default JAX device over a dataset made from a
seed by f5c_tpu/sim.py (random genome, log-normal reads on both strands
with substitutions, indels and soft clips, simulated R9.4 signal in
BLOW5) and prints ONE JSON line with reads/s and the device it ran on.

Usage: python bench.py [--tool=eventalign] [--engine=native|device]
                       [--seed=N] [--reads=N]
"""

import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def _arg(name, default):
    for a in sys.argv:
        if a.startswith(f"--{name}="):
            return a.split("=", 1)[1]
    return default


def setup_dataset(tmp: str, blow5: bool = True, seed: int = 1,
                  n_reads: int = 1024):
    """Generate + index the dataset; returns (bam, genome, reads,
    n_reads, blow5 path)."""
    from f5c_tpu.io.readdb import ReadDB
    from f5c_tpu.sim import genome_mapped

    ds = genome_mapped(os.path.join(tmp, "sim"), seed=seed,
                       n_reads=n_reads)
    ReadDB(ds["reads"]).build(slow5_path=ds["blow5"])
    return (ds["bam"], ds["genome"], ds["reads"], len(ds["reads_list"]),
            ds["blow5"])


def run_once(bam, genome, reads, out_path, slow5=None, tool="meth"):
    from f5c_tpu.pipeline.runner import Options, Pipeline

    opt = Options(min_mapq=0, slow5_path=slow5)
    pipe = Pipeline(bam, genome, reads, opt)
    t0 = time.time()
    with open(out_path, "w") as out:
        if tool == "meth":
            pipe.call_methylation(out=out)
        else:
            from types import SimpleNamespace

            from f5c_tpu.pipeline.eventalign import run_eventalign

            run_eventalign(pipe, SimpleNamespace(), out=out)
    wall = time.time() - t0
    return wall, pipe


def main():
    tool = "eventalign" if "--tool=eventalign" in sys.argv else "meth"
    for a in sys.argv:
        # eventalign engine: --engine=native|python|device (default:
        # auto, which is native)
        if a.startswith("--engine="):
            os.environ["F5C_TPU_EA_ENGINE"] = a.split("=", 1)[1]
    tmp = tempfile.mkdtemp(prefix="f5c_bench_")
    try:
        bam, genome, reads, n_reads, slow5 = setup_dataset(
            tmp, seed=int(_arg("seed", 1)), n_reads=int(_arg("reads", 1024)))
        # two warm-up runs: the first compiles, the second flushes
        # residual first-call costs (autotuning etc.); then measure
        w0, _ = run_once(bam, genome, reads, os.path.join(tmp, "w.tsv"),
                         slow5, tool)
        w1, _ = run_once(bam, genome, reads, os.path.join(tmp, "w.tsv"),
                         slow5, tool)
        walls = []
        wall, pipe = None, None
        for _ in range(3):
            w, p = run_once(bam, genome, reads,
                            os.path.join(tmp, "m.tsv"), slow5, tool)
            walls.append(w)
            if wall is None or w < wall:
                wall, pipe = w, p
        n_proc = pipe.counters["processed"]
        bases = sum(
            e.length for e in
            __import__("f5c_tpu.io.fasta", fromlist=["FastaIndex"])
            .FastaIndex(reads).entries.values())
        reads_per_s = n_proc / wall
        name = ("call-methylation" if tool == "meth" else "eventalign")
        print(
            f"[bench] warmups {w0:.1f}s/{w1:.1f}s measured "
            f"{'/'.join(f'{w:.2f}' for w in walls)}s best {wall:.2f}s "
            f"{n_proc} reads {bases} bases "
            f"({bases/wall/1e6:.2f} Mbases/s); stages: "
            + " ".join(f"{k}={v:.2f}" for k, v in pipe.stage_time.items()),
            file=sys.stderr)
        detail = getattr(pipe, "stage_detail", None)
        if detail:
            print("[bench] detail: " + " ".join(
                f"{k}={v:.0f}" if k.endswith(("_bytes", "_dispatch",
                                              "_cells", "_events"))
                else f"{k}={v:.3f}"
                for k, v in sorted(detail.items())), file=sys.stderr)
            bc = detail.get("align.band_cells", 0.0)
            ne = detail.get("align.n_events", 0.0)
            if bc:
                print(f"[bench] absolute: {bc/wall/1e6:.1f} Mband-cells/s "
                      f"{ne/wall/1e3:.0f} kevents/s", file=sys.stderr)
        import jax

        dev = jax.devices()[0]
        print(json.dumps({
            "metric": f"generated genome-mapped {name} throughput",
            "value": round(reads_per_s, 2),
            "unit": "reads/s",
            "runs_wall_s": [round(w, 3) for w in walls],
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        }))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
