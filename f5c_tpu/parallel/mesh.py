"""Device-mesh scaling: data-parallel read batches over `jax.sharding`.

The pore model and reference tables are tiny (<= 2M floats) and replicated;
reads are embarrassingly parallel, so the mesh is a single 'data' axis
over the local devices.  The cards of a host are joined all to all, so
the mesh follows the algorithm alone.  Host-side, each process feeds its
own shard of the BAM stream (read_idx % n_hosts) and outputs merge
deterministically by read index — the distributed analogue of the
reference's per-host file sharding + freq-merge (SURVEY §2.7).

Inputs are placed with a ``NamedSharding`` straight from the host: each
device receives its own shard (or its replica) without a detour through
device 0.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(devices=None) -> Mesh:
    """1-D data-parallel mesh over all (or given) devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), axis_names=("data",))


def put_sharded(mesh: Mesh, a):
    """Host array with a leading device axis -> one shard per device."""
    return jax.device_put(a, NamedSharding(mesh, P("data")))


def put_replicated(mesh: Mesh, a):
    """Host (or device) array -> a full replica on every device."""
    return jax.device_put(a, NamedSharding(mesh, P()))


# per-device transfer accounting for sharded dispatches: evidence that
# the host can feed N devices (per-device H2D shrinks with the mesh while
# replicated tables stay constant).  Keys: <kind>.{n_dispatch,
# sharded_bytes, replicated_bytes, per_device_bytes}.
TRANSFER_LOG: dict[str, float] = {}


def record_dispatch(kind: str, sharded_bytes: int, replicated_bytes: int,
                    n_dev: int) -> None:
    def add(key, v):
        TRANSFER_LOG[key] = TRANSFER_LOG.get(key, 0.0) + v

    add(f"{kind}.n_dispatch", 1)
    add(f"{kind}.sharded_bytes", float(sharded_bytes))
    add(f"{kind}.replicated_bytes", float(replicated_bytes))
    add(f"{kind}.per_device_bytes",
        float(sharded_bytes) / max(n_dev, 1) + float(replicated_bytes))


def transfer_table() -> str:
    """Human-readable per-device H2D table (one row per dispatch kind)."""
    kinds = sorted({k.rsplit(".", 1)[0] for k in TRANSFER_LOG})
    rows = ["kind            disp   sharded_MB  replicated_MB  "
            "per_device_MB"]
    for k in kinds:
        g = lambda f: TRANSFER_LOG.get(f"{k}.{f}", 0.0)  # noqa: E731
        rows.append(f"{k:<15} {int(g('n_dispatch')):>4}   "
                    f"{g('sharded_bytes') / 1e6:>10.3f}  "
                    f"{g('replicated_bytes') / 1e6:>13.3f}  "
                    f"{g('per_device_bytes') / 1e6:>13.3f}")
    return "\n".join(rows)


def _shard_map(fn, mesh, in_specs, out_specs):
    # check_vma would demand varying-mesh-axis annotations on the FFI
    # call's results; every body here is a per-device program
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


@functools.partial(jax.jit, static_argnames=("mesh", "impl", "E", "K",
                                             "n_trace_bands", "cap"))
def shard_abea(mesh: Mesh, impl, ev_pool, rk_pool, meta_i, meta_f,
               byte_off, level_mean, level_stdv, level_log_stdv, *,
               E: int, K: int, n_trace_bands: int, cap: int):
    """The ABEA launch ``impl`` (ops/route.abea_impl) with the read axis
    data-parallel over the mesh.  Pools and launch metadata carry a
    leading device axis (one shard per device); the model tables are
    replicated.  Each device runs the unmodified one-device launch."""
    def run(ev, rk, mi, mf, bo, lm, ls, ll):
        flat, start_e, n = impl(ev[0], rk[0], mi[0], mf[0], bo[0], lm, ls,
                                ll, E=E, K=K, n_trace_bands=n_trace_bands,
                                cap=cap)
        return flat[None], start_e[None], n[None]

    sharded, repl = P("data"), P()
    fn = _shard_map(run, mesh, in_specs=(sharded,) * 5 + (repl,) * 3,
                    out_specs=(sharded, sharded, sharded))
    return fn(ev_pool, rk_pool, meta_i, meta_f, byte_off, level_mean,
              level_stdv, level_log_stdv)


@functools.partial(jax.jit, static_argnames=("mesh", "SEG", "k",
                                             "use_i16", "pad_events"))
def shard_hmm_forward(mesh: Mesh, meta, packed_ref, read_tab, ev_pool,
                      level_mean, level_stdv, level_log_stdv,
                      SEG: int, k: int, use_i16: bool, pad_events: int):
    """The profile-HMM scorer with on-device input assembly
    (ops/hmm_meta.hmm_forward_meta) with the window axis data-parallel
    over the mesh: ``meta`` carries a leading device axis; the packed
    reference, read table, event pool and model tables are replicated.
    Returns scores [D, n_rows_d, 128 // SEG]."""
    from ..ops.hmm_meta import hmm_forward_meta

    def run(mt, pr, rt, pool, lm, ls, ll):
        s = hmm_forward_meta(mt[0], pr, rt, pool, lm, ls, ll, SEG=SEG, k=k,
                             use_i16=use_i16, pad_events=pad_events)
        return s[None]

    sharded, repl = P("data"), P()
    fn = _shard_map(run, mesh, in_specs=(sharded,) + (repl,) * 6,
                    out_specs=sharded)
    return fn(meta, packed_ref, read_tab, ev_pool, level_mean, level_stdv,
              level_log_stdv)
