"""ABEA routes and the launch contract (ops/route.py, ops/abea.py,
ops/abea_cuda.py).

- The XLA route vs the NumPy oracle (ops/abea_ref.py): aligned pairs equal
  bit for bit on seeded simulated reads at band width 100.
- The route chooser: XLA on the CPU; on the GPU a CUDA library that
  cannot be built or loaded raises (no fallback); other backends raise.
- Launch planning: read-axis padding with empty reads, ragged offsets,
  widening for the mesh.
- An ultra-long read takes an ordinary launch of its own.
- On the card (``gpu`` marker): the CUDA kernel vs the oracle.
"""

import numpy as np
import pytest

from f5c_tpu import sim
from f5c_tpu.models import builtin_model
from f5c_tpu.ops import abea, abea_ref


def _reads(seed, specs):
    """specs: (length, reverse, indels) -> [(SimRead, events, ranks,
    scaling)] from f5c_tpu/sim.py."""
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(seed)
    genome = sim.random_genome(rng, 60_000)
    out = []
    for i, (n, reverse, indels) in enumerate(specs):
        while True:
            r = sim.mapped_read(rng, genome, f"r{i}", n,
                                err=0.01 if indels else 0.0, clip_p=0.0)
            has_indel = any(op in (1, 2) for op, _ in r.cigar)
            if r.is_reverse == reverse and has_indel == indels:
                break
        out.append((r, *sim.read_events(rng, r.read_seq, model)))
    return model, out


@pytest.mark.parametrize("length,reverse,indels", [
    (1000, False, False), (3000, False, False), (2000, True, False),
    (5000, True, False), (2500, False, True), (4000, True, True)])
def test_xla_abea_matches_oracle(length, reverse, indels):
    model, reads = _reads(length + reverse, [(length, reverse, indels)])
    (r, ev, rk, sc), = reads
    ref = abea_ref.align(r.read_seq, ev, model, sc)
    assert not ref.failed
    pairs, = abea.align_reads(abea.abea_align_xla, [ev], [rk], [sc], model)
    np.testing.assert_array_equal(pairs, ref.pairs)


def test_route_on_cpu_is_xla():
    from f5c_tpu.ops import route

    assert route.platform() == "cpu"
    assert route.abea_impl() is abea.abea_align_xla


def test_route_on_gpu_raises_without_cuda_library(monkeypatch):
    import jax

    from f5c_tpu.ops import abea_cuda, route

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(abea_cuda, "_state", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(abea_cuda, "nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        route.abea_impl()
    monkeypatch.setattr(abea_cuda, "build",
                        lambda: "/nonexistent/libabea_cuda.so")
    with pytest.raises(RuntimeError, match="cannot load"):
        route.abea_impl()


def test_route_rejects_other_backends(monkeypatch):
    import jax

    from f5c_tpu.ops import route

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="no device route"):
        route.abea_impl()


def test_plan_launch_pads_with_empty_reads():
    ev_len = np.array([100, 300, 50])
    rk_len = np.array([60, 170, 30])
    ev_off = np.array([0, 100, 400])
    rk_off = np.array([0, 60, 230])
    p = abea.plan_launch(ev_off, ev_len, rk_off, rk_len, [1.0] * 3,
                         [0.0] * 3)
    assert p.meta_i.shape == (8, 5) and p.meta_f.shape == (8, 6)
    assert (p.meta_i[3:, 1] == 0).all() and (p.meta_i[3:, 3] == 0).all()
    bands = ev_len + rk_len + 2
    assert list(p.meta_i[:3, 4]) == [0, bands[0], bands[0] + bands[1]]
    cap = (ev_len + rk_len + 3) // 4
    assert list(p.byte_off[:4]) == [0, cap[0], cap[0] + cap[1], cap.sum()]
    assert (p.byte_off[4:] == cap.sum()).all()
    assert (p.E, p.K) == (512, 256)
    assert p.n_trace_bands >= bands.sum() and p.cap >= cap.sum()
    # hi + lo carries the double-precision transition log-probabilities
    stay, step = abea.transition_lps(ev_len, rk_len)
    got = p.meta_f[:3, 2].astype(np.float64) + p.meta_f[:3, 3]
    np.testing.assert_allclose(got, stay, rtol=1e-13)
    wide = abea.plan_launch(ev_off[:1], ev_len[:1], rk_off[:1], rk_len[:1],
                            [1.0], [0.0], at_least=p.sizes)
    assert wide.sizes == p.sizes
    assert p.trace_bytes("gpu") == 32 * p.n_trace_bands
    assert p.trace_bytes("cpu") == 8 * (p.E + p.K + 2) * 128


def test_ultra_long_read_takes_its_own_launch():
    from f5c_tpu.pipeline.runner import Options, Pipeline, ReadRecord

    model, reads = _reads(7, [(1200, False, False), (3000, True, False),
                              (1500, False, True), (1300, True, False)])
    pipe = Pipeline.bare(Options(ultra_thresh=2500), model)
    batch = [ReadRecord(qname=r.qname, read_idx=i, tid=0, pos=r.pos,
                        cigar=r.cigar, is_reverse=r.is_reverse,
                        seq=r.read_seq, event_means=ev,
                        n_events=ev.shape[0], scaling=sc)
             for i, (r, ev, rk, sc) in enumerate(reads)]
    todo = sorted(batch, key=lambda r: r.n_events)
    ev_len = np.array([r.n_events for r in todo])
    rk_len = np.array([len(r.seq) - model.k + 1 for r in todo])
    groups = pipe._launch_groups(todo, np.cumsum(ev_len) - ev_len, ev_len,
                                 np.cumsum(rk_len) - rk_len, rk_len)
    sizes = [[len(r.seq) for r in todo[lo:hi]] for lo, hi, _ in groups]
    assert [3000] in sizes and sum(map(len, sizes)) == 4
    pipe.align_batch(batch)
    assert pipe.stage_detail["align.n_dispatch"] == len(groups)
    for rec, (r, ev, rk, sc) in zip(batch, reads):
        ref = abea_ref.align(r.read_seq, ev, model, sc)
        np.testing.assert_array_equal(rec.pairs, ref.pairs)


@pytest.mark.gpu
def test_cuda_abea_matches_oracle(gpu):
    from f5c_tpu.ops import abea_cuda

    model, reads = _reads(3, [(1000, False, False), (2000, True, True),
                              (5000, False, True), (12000, True, False)])
    got = abea.align_reads(abea_cuda.abea_align_cuda,
                           *zip(*[(ev, rk, sc) for _, ev, rk, sc in reads]),
                           model)
    for (r, ev, rk, sc), pairs in zip(reads, got):
        ref = abea_ref.align(r.read_seq, ev, model, sc)
        np.testing.assert_array_equal(pairs, ref.pairs)
