"""Multi-process (multi-host) execution via jax.distributed.

The reference has no distributed backend — users shard inputs across
cluster jobs by hand and merge with `freq-merge`
(/root/reference/scripts/pipelines/methcall-ultra-pipeline.pbs.sh,
src/freq_merge.c).  Here the framework owns that layer (SURVEY §2.7):

- every process calls :func:`initialize` (the jax.distributed
  coordination service; also works with N CPU processes for tests) and
  drives one local device;
- reads are data-parallel sharded by ``read_idx % process_count`` —
  exactly the single-process ``--shard I/N`` machinery, so the sharded
  compute path is identical and already parity-tested
  (tests/test_sharding.py);
- each process writes ``<output>.partN`` with one marker line
  ``#f5c-dist\t<read_idx>`` preceding each read's rows
  (``Options.dist_markers``);
- a coordination-service barrier, then process 0 k-way merges the parts
  by read index — byte-identical to the single-process output — and
  removes them (:func:`finalize`).

CLI: ``f5c-tpu call-methylation/eventalign --dist -o out.tsv`` plus
``--dist-coordinator HOST:PORT --dist-rank I --dist-nprocs N`` for
manual launches (auto-detected under SLURM).

The merge is exact, not tolerance-based: the per-read rows of a shard
are produced by the same code on the same reads as a single-process
run, so interleaving blocks by read_idx reproduces the BAM-order file.

No device collectives are required (per-read outputs are strings; the
only associative reduction in the toolchain — meth-freq site counts —
already merges via `freq-merge`).  The barrier and the merge ride the
jax.distributed coordination service, so the layer works on CPU
processes, several cards of one host, and several hosts alike.
"""

from __future__ import annotations

import heapq
import os

MARKER = "#f5c-dist\t"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> tuple[int, int]:
    """Join the jax.distributed coordination service.

    With no arguments, jax auto-detects the cluster environment
    (SLURM...).  For manual launches (tests, bare clusters) pass
    ``coordinator`` ("host:port"), ``num_processes`` and ``process_id``.
    A process drives one card: the one at its process index modulo the
    host's device count (``local_device_ids``), so several processes of
    one host never open the same card.  Returns (process_index,
    process_count).
    """
    import jax

    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
        cards = _local_cards()
        if cards and "JAX_LOCAL_DEVICE_IDS" not in os.environ:
            kwargs["local_device_ids"] = [process_id % cards]
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def _local_cards() -> int:
    """NVIDIA cards on this host, counted without starting JAX's backend
    (0 where there are none, e.g. CPU-only test runs)."""
    if os.environ.get("JAX_PLATFORMS", "").strip() == "cpu":
        return 0
    try:
        return len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        return 0


def barrier(name: str, timeout_ms: int = 3600 * 1000) -> None:
    """Block until every process reaches ``name``."""
    from jax._src import distributed

    client = distributed.global_state.client
    if client is None:
        raise RuntimeError("jax.distributed is not initialized")
    client.wait_at_barrier(name, timeout_ms)


def part_path(output: str, rank: int) -> str:
    return f"{output}.part{rank}"


def merge_marked_parts(parts: list[str], out_path: str) -> int:
    """K-way merge marker-tagged shard outputs into ``out_path``.

    Each part is (header, then blocks of `#f5c-dist\\t<idx>` + rows).
    Blocks within a part are strictly increasing in read index (BAM
    iteration order), so a heap merge restores global order.  The
    header is taken from the first part.  Returns merged block count.
    """

    def blocks(path):
        idx, buf = None, []
        with open(path) as fh:
            for line in fh:
                if line.startswith(MARKER):
                    if idx is not None:
                        yield idx, "".join(buf)
                    idx = int(line[len(MARKER):])
                    buf = []
                elif idx is None:
                    continue  # shard header
                else:
                    buf.append(line)
            if idx is not None:
                yield idx, "".join(buf)

    header = ""
    if parts:
        with open(parts[0]) as fh:
            for line in fh:
                if line.startswith(MARKER):
                    break
                header += line
    n = 0
    with open(out_path, "w") as out:
        out.write(header)
        for _idx, text in heapq.merge(*(blocks(p) for p in parts)):
            out.write(text)
            n += 1
    return n


def finalize(outputs: list[str], rank: int, nprocs: int,
             keep_parts: bool = False) -> None:
    """Barrier, then process 0 merges every output's shard parts.

    Each process must already have written ``<output>.part<rank>`` with
    ``#f5c-dist`` markers (``opt.dist_markers``) for every path in
    ``outputs``.  After the merge the part files are removed and a
    second barrier releases all processes.
    """
    barrier("f5c-output-done")
    if rank == 0:
        for output in outputs:
            parts = [part_path(output, r) for r in range(nprocs)]
            merge_marked_parts(parts, output)
            if not keep_parts:
                for p in parts:
                    os.remove(p)
    barrier("f5c-merge-done")
