"""Mesh parity harness: call-methylation and eventalign over a dataset
twice in one process — once on one device, once data-parallel over every
local device — and require byte-identical outputs.

The one-device run takes the wave schedule (``align_batch_waved``); the
mesh run deals reads over the devices (``_align_sharded``,
``shard_hmm_forward``; eventalign's realign runs on the host).  Used by
tests/test_mesh.py (the vendored golden set on 4 virtual CPU devices),
``chip_smoke.py --chips 4`` (the generated set on 4 cards) and
``__graft_entry__.dryrun_multichip``.

Usage: python -m f5c_tpu.parallel.mesh_check [dataset_dir]
(default: tests/data/golden; the directory holds genome.fa, reads.fasta,
reads.bam and signals.blow5).
"""

from __future__ import annotations

import io
import os
import shutil
import tempfile
import time
from types import SimpleNamespace

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "data", "golden")
FILES = ("genome.fa", "reads.fasta", "reads.bam", "signals.blow5")


def run_outputs(src_dir: str, work: str, mesh: bool,
                opt_kw: dict | None = None) -> dict:
    """call-methylation TSV + eventalign TSV/summary for the dataset in
    ``src_dir`` (indexed in ``work``), on the mesh or on one device."""
    from ..io.readdb import ReadDB
    from ..pipeline.eventalign import run_eventalign
    from ..pipeline.runner import Options, Pipeline

    os.makedirs(work, exist_ok=True)
    for f in FILES:
        shutil.copy(os.path.join(src_dir, f), work)
    reads = os.path.join(work, "reads.fasta")
    slow5 = os.path.join(work, "signals.blow5")
    ReadDB(reads).build(slow5_path=slow5)
    opt_kw = dict(min_mapq=0, slow5_path=slow5, num_proc=1,
                  **(opt_kw or {}))
    env = {"F5C_TPU_MESH": "1" if mesh else "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        def pipeline():
            return Pipeline(os.path.join(work, "reads.bam"),
                            os.path.join(work, "genome.fa"), reads,
                            Options(**opt_kw))

        t0 = time.perf_counter()
        meth = io.StringIO()
        pipeline().call_methylation(out=meth)
        t_meth = time.perf_counter() - t0
        ea = io.StringIO()
        summary = os.path.join(work, "summary.tsv")
        t0 = time.perf_counter()
        run_eventalign(pipeline(), SimpleNamespace(summary=summary), out=ea)
        t_ea = time.perf_counter() - t0
        with open(summary) as f:
            summ = f.read()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return dict(meth=meth.getvalue(), eventalign=ea.getvalue(),
                summary=summ, secs=dict(meth=t_meth, eventalign=t_ea))


def run_mesh_parity(src_dir: str = GOLDEN, opt_kw: dict | None = None,
                    log=print) -> dict:
    """Run both ways; raises AssertionError on any byte difference.
    Returns the per-output row counts and walls."""
    import jax

    from .mesh import TRANSFER_LOG, transfer_table

    n_dev = len(jax.local_devices())
    assert n_dev >= 2, f"need a multi-device mesh, have {n_dev}"
    TRANSFER_LOG.clear()
    tmp = tempfile.mkdtemp(prefix="f5c_mesh_")
    try:
        # one work directory for both: the summary names signal paths
        single = run_outputs(src_dir, tmp, False, opt_kw)
        sharded = run_outputs(src_dir, tmp, True, opt_kw)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = {}
    for key in ("meth", "eventalign", "summary"):
        a, b = single[key], sharded[key]
        assert a == b, f"{key} differs between 1 and {n_dev} devices"
        rows[key] = a.count("\n") - 1
        assert rows[key] > 0, f"{key}: no output rows"
    log(f"[mesh_check] {n_dev} devices == 1 device byte for byte: "
        + ", ".join(f"{k} {v} rows" for k, v in rows.items()))
    for tag, res in (("1 device", single), (f"{n_dev} devices", sharded)):
        log(f"[mesh_check] {tag}: call-methylation "
            f"{res['secs']['meth']:.3f} s, eventalign "
            f"{res['secs']['eventalign']:.3f} s")
    log("[mesh_check] per-device H2D accounting (mesh run):")
    log(transfer_table())
    return dict(rows=rows, single=single["secs"], sharded=sharded["secs"])


if __name__ == "__main__":
    import sys

    run_mesh_parity(sys.argv[1] if len(sys.argv) > 1 else GOLDEN)
    print("[mesh_check] OK")
