"""Native host library vs the NumPy oracles.

Every native function must reproduce its Python reference implementation
bit-for-bit (they are ports of the same float-exact semantics), on both
synthetic signals and a real read from the vendored dataset.
"""

import glob
import os

import numpy as np
import pytest

from f5c_tpu import native
from f5c_tpu.models import builtin_model
from f5c_tpu.ops import events_ref
from f5c_tpu.ops.abea_ref import (align, estimate_scalings_using_mom,
                                  postalign, recalibrate_model)

ECOLI = "/root/reference/test/ecoli_2kb_region"

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native toolchain unavailable")


def _real_signal():
    from f5c_tpu.io.fast5 import read_fast5_signal

    path = sorted(glob.glob(os.path.join(ECOLI, "fast5_files", "*.fast5")))[0]
    return read_fast5_signal(path).to_pa()


@pytest.mark.parametrize("rna", [False, True])
def test_detect_events_matches_oracle_synthetic(rna):
    rng = np.random.default_rng(7)
    # piecewise-constant signal with noise, like a real squiggle
    levels = rng.uniform(60, 120, 200)
    lens = rng.integers(3, 30, 200)
    sig = np.repeat(levels, lens) + rng.normal(0, 1.5, int(lens.sum()))
    sig = sig.astype(np.float32)
    ref = events_ref.detect_events(sig, rna=rna)
    nat = native.detect_events(sig, rna=rna)
    np.testing.assert_array_equal(nat.start, ref.start)
    np.testing.assert_array_equal(nat.length, ref.length)
    np.testing.assert_array_equal(nat.mean, ref.mean)
    np.testing.assert_array_equal(nat.stdv, ref.stdv)


@pytest.mark.skipif(not os.path.isdir(ECOLI), reason="dataset missing")
def test_detect_events_matches_oracle_real_read():
    sig = _real_signal()
    ref = events_ref.detect_events(sig)
    nat = native.detect_events(sig)
    np.testing.assert_array_equal(nat.start, ref.start)
    np.testing.assert_array_equal(nat.mean, ref.mean)


def test_kmer_ranks():
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("ACGT"), 500))
    np.testing.assert_array_equal(
        native.kmer_ranks(seq, 6), model.kmer_ranks(seq))
    cpg = builtin_model("dna_r9_cpg")
    mseq = seq.replace("CG", "MG")
    np.testing.assert_array_equal(
        native.kmer_ranks(mseq, 6, meth=True), cpg.kmer_ranks(mseq))


def test_mom_scalings():
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(2)
    seq = "".join(rng.choice(list("ACGT"), 400))
    ranks = model.kmer_ranks(seq)
    ev = (model.level_mean[rng.integers(0, 4096, 900)]
          + rng.normal(0, 2, 900)).astype(np.float32)
    ref = estimate_scalings_using_mom(seq, model, ev)
    nat = native.mom_scalings(ev, ranks.astype(np.int32), model.level_mean)
    assert nat.shift == ref.shift
    assert nat.scale == ref.scale


def test_postalign_recalibrate_matches_oracle():
    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGT"), 400))
    ranks = model.kmer_ranks(seq)
    # events that walk the read's kmers in order (with stays)
    which = np.sort(rng.integers(0, len(ranks), 1200))
    ev = (model.level_mean[ranks[which]]
          + rng.normal(0, 0.5, 1200)).astype(np.float32)
    sc = estimate_scalings_using_mom(seq, model, ev)
    res = align(seq, ev, model, sc)
    assert not res.failed
    post = postalign(res.pairs, seq, len(ranks), model)
    ok_ref, rc_ref = recalibrate_model(model, ev, post, seq, 200)
    ok, b2e_s, b2e_e, epb, rc = native.postalign_recalibrate(
        res.pairs, ranks.astype(np.int32), ev, model.level_mean,
        model.level_stdv, 200)
    np.testing.assert_array_equal(b2e_s, post.base_to_event_start)
    np.testing.assert_array_equal(b2e_e, post.base_to_event_stop)
    assert epb == post.events_per_base
    assert ok == ok_ref
    if ok:
        assert rc.shift == rc_ref.shift
        assert rc.scale == rc_ref.scale
        assert rc.var == rc_ref.var


def test_disambiguate():
    s = b"acgtNRYSWKMBDHVXcg"
    from f5c_tpu.pipeline.methylation import disambiguate as py_disamb

    assert native.disambiguate(s).decode() == py_disamb(s.decode())


def test_collect_meth_groups_matches_python():
    from f5c_tpu.pipeline.methylation import collect_meth_groups

    rng = np.random.default_rng(5)
    ref_seq = "".join(rng.choice(list("ACGT"), p=[.3, .2, .2, .3], size=2000))
    read_length = 2000
    k = 6
    n_kmers = read_length - k + 1
    b2e = np.arange(n_kmers, dtype=np.int32) * 2
    b2e[rng.integers(0, n_kmers, 300)] = -1
    cigar = [(0, 2000)]
    for rev in (False, True):
        py = collect_meth_groups(ref_seq, 1000, cigar, rev, read_length,
                                 b2e, k)
        dis = native.disambiguate(ref_seq.encode())
        nat = native.collect_meth_groups(
            dis, 1000, np.array([0], np.int32), np.array([2000], np.int32),
            rev, read_length, b2e, k)
        assert len(py) == len(nat["start_pos"])
        for i, g in enumerate(py):
            assert nat["start_pos"][i] == g.site.start_position
            assert nat["end_pos"][i] == g.site.end_position
            assert nat["n_cpg"][i] == g.site.n_cpg
            assert nat["e1"][i] == g.unmeth.event_start_idx
            assert nat["e2"][i] == g.unmeth.event_stop_idx
            sub = dis[nat["sub_start"][i]:nat["sub_end"][i] + 1].decode()
            assert sub == g.unmeth.seq


def test_hmm_assemble_matches_make_hmm_batch():
    from f5c_tpu.ops.abea_ref import Scalings
    from f5c_tpu.ops.hmm import make_hmm_batch
    from f5c_tpu.pipeline.methylation import (HmmWorkItem, methylate,
                                              reverse_complement,
                                              reverse_complement_meth)

    cpg = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(6)
    ev = (rng.uniform(60, 120, 500)).astype(np.float32)
    ref_seq = "".join(rng.choice(list("ACGT"), 300))
    sc = Scalings(shift=3.1, scale=0.97, var=1.2)
    items = []
    nat_items = []
    for rc in (False, True):
        for do_meth in (0, 1):
            sub = ref_seq[40:101]
            m_seq = methylate(sub) if do_meth else sub
            m_rc = (reverse_complement_meth(m_seq) if do_meth
                    else reverse_complement(m_seq))
            items.append(HmmWorkItem(m_seq, m_rc, 10, 80, 1, rc))
            nat_items.append((40, 100, do_meth, 10, 80, rc))
    pad_e, pad_k = 128, 64
    hb = make_hmm_batch(items, [ev] * 4, cpg, [sc] * 4, [2.5] * 4,
                        pad_e, pad_k)
    # native path: reads 0/1 forward, 2/3 reverse (read index per item)
    ref_concat = ref_seq.encode()
    ref_off = np.zeros(2, dtype=np.int64)
    ev_off = np.zeros(2, dtype=np.int64)
    out = native.hmm_assemble(
        4, pad_k, pad_e, cpg.k, ref_concat, ref_off,
        np.ascontiguousarray(ev), ev_off,
        np.array([0, 0, 1, 1], np.int32),
        np.array([40] * 4, np.int64), np.array([100] * 4, np.int64),
        np.array([0, 1, 0, 1], np.uint8),
        np.array([10] * 4, np.int64), np.array([80] * 4, np.int64),
        np.array([0, 1], np.uint8),
        np.full(2, sc.scale, np.float32), np.full(2, sc.shift, np.float32),
        np.full(2, sc.var, np.float32), np.full(2, 2.5, np.float32), cpg)
    gp_mean, gp_inv, gp_log, ev_out, n_km, n_ev, lp_stay, lp_step = out
    np.testing.assert_array_equal(np.asarray(hb.n_kmers), n_km)
    np.testing.assert_array_equal(np.asarray(hb.n_events), n_ev)
    np.testing.assert_allclose(np.asarray(hb.gp_mean), gp_mean, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hb.gp_inv_stdv), gp_inv, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hb.gp_log_stdv), gp_log, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(hb.event_means), ev_out)
    np.testing.assert_allclose(np.asarray(hb.lp_stay), lp_stay, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(hb.lp_step), lp_step, rtol=1e-6)


def test_abea_assemble_matches_make_batch():
    from f5c_tpu.ops import abea
    from f5c_tpu.ops.abea_ref import Scalings

    model = builtin_model("dna_r9_nucleotide")
    rng = np.random.default_rng(8)
    evs, rks, scs = [], [], []
    for i in range(3):
        n = int(rng.integers(50, 200))
        evs.append(rng.uniform(60, 120, n).astype(np.float32))
        rks.append(rng.integers(0, 4096, n // 2).astype(np.int64))
        scs.append(Scalings(shift=float(i), scale=1.0 + 0.1 * i, var=1.0))
    E, K = 256, 128
    ref = abea.make_batch(evs, rks, model, pad_events=E, pad_kmers=K,
                          scalings=scs)
    ev_concat = np.concatenate(evs)
    ev_off = np.array([0, evs[0].size, evs[0].size + evs[1].size], np.int64)
    ev_len = np.array([e.size for e in evs], np.int64)
    rk_concat = np.concatenate(rks).astype(np.int32)
    rk_off = np.array([0, rks[0].size, rks[0].size + rks[1].size], np.int64)
    rk_len = np.array([r.size for r in rks], np.int64)
    out = native.abea_assemble(
        3, E, abea.PAD, ev_concat, ev_off, ev_len, rk_concat, rk_off, rk_len,
        model, np.array([s.scale for s in scs], np.float32),
        np.array([s.shift for s in scs], np.float32), K)
    ev, km, ks, kl, n_ev, n_km, scale, shift, lp_stay, lp_step = out
    np.testing.assert_array_equal(np.asarray(ref.event_means), ev)
    np.testing.assert_array_equal(np.asarray(ref.kmer_mean), km)
    np.testing.assert_array_equal(np.asarray(ref.kmer_stdv), ks)
    np.testing.assert_array_equal(np.asarray(ref.kmer_log_stdv), kl)
    np.testing.assert_array_equal(np.asarray(ref.n_events), n_ev)
    np.testing.assert_array_equal(np.asarray(ref.n_kmers), n_km)
    np.testing.assert_array_equal(np.asarray(ref.scale), scale)
    np.testing.assert_array_equal(np.asarray(ref.shift), shift)
    # make_batch carries the double log-probabilities as f32 (hi, lo)
    # pairs; hi is the f32 rounding the native assembler stores
    np.testing.assert_array_equal(np.asarray(ref.lp_stay)[:, 0], lp_stay)
    np.testing.assert_array_equal(np.asarray(ref.lp_step)[:, 0], lp_step)


@pytest.mark.skipif(not os.path.isdir(ECOLI), reason="dataset missing")
def test_prep_read_matches_four_call_path():
    """f5c_prep_read (one ctypes crossing) == adc_to_pa + detect_events
    + kmer_ranks + mom_scalings, bit-for-bit."""
    import glob

    from f5c_tpu.io.fast5 import read_fast5_signal

    path = sorted(glob.glob(os.path.join(ECOLI, "fast5_files",
                                         "*.fast5")))[0]
    sig = read_fast5_signal(path)
    seq = "ACGTACGTTG" * 400
    model = builtin_model("dna_r9_nucleotide")
    lm = model.level_mean
    et2, rk2, sc2, pa2 = native.prep_read(
        sig.raw, sig.digitisation, sig.offset, sig.range, seq, model.k,
        lm, keep_pa=True)
    pa = sig.to_pa()
    et = native.detect_events(pa)
    rk = native.kmer_ranks(seq, model.k)
    sc = native.mom_scalings(et.mean, rk, lm)
    assert np.array_equal(et.start, et2.start)
    assert np.array_equal(et.length, et2.length)
    assert np.array_equal(et.mean, et2.mean)
    assert np.array_equal(et.stdv, et2.stdv)
    assert np.array_equal(rk, rk2)
    assert sc.shift == sc2.shift and sc.scale == sc2.scale
    assert np.array_equal(pa, pa2)


def test_decode_qc_postalign_split_parity():
    """The walk/emission split (+AVX-512 gathers) is bit-identical to a
    fused-order f32 replication: sum_emission, max_gap, pairs."""
    rng = np.random.default_rng(123)
    f32 = np.float32
    for trial in range(5):
        n_kmers = int(rng.integers(50, 1500))
        n_events = int(rng.integers(n_kmers, 3 * n_kmers))
        ranks = rng.integers(0, 4096, n_kmers).astype(np.int32)
        lm = rng.normal(90, 10, 4096).astype(f32)
        ls = rng.uniform(0.8, 3.0, 4096).astype(f32)
        lls = np.log(ls).astype(f32)
        ev = rng.normal(90, 12, n_events).astype(f32)
        scale, shift = f32(rng.uniform(0.9, 1.1)), f32(rng.uniform(-5, 5))
        k, e = n_kmers - 1, n_events - 1
        dirs = []
        while k > 0 and e > 0:
            d = int(rng.choice([0, 1, 2], p=[0.5, 0.35, 0.15]))
            if d == 1 and e == 0:
                d = 0
            if d in (0, 2) and k == 0:
                d = 1
            dirs.append(d)
            if d == 1:
                e -= 1
            elif d == 0:
                k -= 1
                e -= 1
            else:
                k -= 1
        while k > 0:
            dirs.append(2)
            k -= 1
        n = len(dirs)
        packed = np.zeros((n + 3) // 4, np.uint8)
        for i, d in enumerate(dirs):
            packed[i >> 2] |= d << ((i & 3) * 2)
        kk, ee = n_kmers - 1, n_events - 1
        sum_em = f32(0.0)
        gap = 0
        max_gap = 0
        pk = np.zeros(n, np.int32)
        pe = np.zeros(n, np.int32)
        for i, d in enumerate(dirs):
            pk[n - 1 - i] = kk
            pe[n - 1 - i] = ee
            rk = ranks[kk]
            a = f32(f32(ev[ee] - f32(scale * lm[rk] + shift)) / ls[rk])
            em = f32(f32(f32(-0.918938) - lls[rk])
                     + f32(f32(-0.5) * f32(a * a)))
            sum_em = f32(sum_em + em)
            if d == 1:
                ee -= 1
                gap = 0
            elif d == 0:
                kk -= 1
                ee -= 1
                gap = 0
            else:
                kk -= 1
                gap += 1
            max_gap = max(max_gap, gap)
        res = native.decode_qc_postalign(
            packed, n, n_events - 1, ranks, ev, lm, ls, lls,
            float(scale), float(shift), -5.0, 50, 200)
        failed, okc, pairs, b2s, b2p, epb, rc, sum_em_n, max_gap_n = res
        assert sum_em_n == float(sum_em)
        assert max_gap_n == max_gap
        if pairs is not None and len(pairs):
            assert np.array_equal(pairs[:, 0], pk)
            assert np.array_equal(pairs[:, 1], pe)
