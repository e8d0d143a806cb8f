"""The profile-HMM scorer route (ops/hmm_meta.hmm_forward_meta: on-device
input assembly + the XLA scorers of ops/hmm.py) vs the NumPy oracle
(ops/hmm_ref.profile_hmm_score), for windows packed 4 per row (SEG 32)
and one per row (SEG 128), on both strands, unmethylated and methylated.
"""

import numpy as np
import pytest

from f5c_tpu.constants import HMM_P_BAD, HMM_P_SKIP
from f5c_tpu.models import builtin_model
from f5c_tpu.ops.abea_ref import Scalings
from f5c_tpu.ops.hmm_ref import profile_hmm_score, window_kmer_ranks
from f5c_tpu.pipeline.methylation import methylate, reverse_complement_meth

K = 6


def _windows(rng, n_kmers, n_windows):
    """Random reference windows (CpG-rich) of n_kmers kmers each."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    refs = []
    for _ in range(n_windows):
        s = rng.choice(bases, n_kmers + K - 1).tobytes()
        s = s[:3] + b"CG" + s[5:]          # at least one CpG
        refs.append(s)
    return refs


@pytest.mark.parametrize("meth", [0, 1])
@pytest.mark.parametrize("rc", [0, 1])
@pytest.mark.parametrize("seg,n_kmers", [(32, 24), (128, 90)])
def test_hmm_route_matches_oracle(seg, n_kmers, rc, meth):
    import jax.numpy as jnp

    from f5c_tpu.ops.hmm_meta import hmm_forward_meta, pack_meta
    from f5c_tpu.ops.seq_ranks import pack_codes, seq_codes
    from f5c_tpu.pipeline.runner import _ebucket

    model = builtin_model("dna_r9_cpg")
    rng = np.random.default_rng(seg * 10 + rc * 2 + meth)
    refs = _windows(rng, n_kmers, 5)
    sc = Scalings(shift=0.7, scale=1.02, var=1.3)
    epb = 1.8
    ev_parts, items = [], []
    for w in refs:
        seq = w.decode()
        m_seq = methylate(seq) if meth else seq
        ranks = window_kmer_ranks(m_seq, reverse_complement_meth(m_seq),
                                  bool(rc), model)
        reps = rng.integers(1, 4, ranks.shape[0])
        ev = (sc.scale * np.repeat(model.level_mean[ranks], reps) + sc.shift
              + rng.normal(0, 1.5, int(reps.sum()))).astype(np.float32)
        items.append((m_seq, sum(e.shape[0] for e in ev_parts),
                      ev.shape[0]))
        ev_parts.append(ev)
    ev_pool = np.concatenate(ev_parts)
    truth = [profile_hmm_score(m_seq, reverse_complement_meth(m_seq),
                               ev_pool, sc, model, e0, e0 + ne - 1, 1,
                               bool(rc), epb)
             for m_seq, e0, ne in items]

    ref_concat = b"".join(refs)
    gstart = np.cumsum([0] + [len(w) for w in refs[:-1]]).astype(np.int32)
    segs = 128 // seg
    n_alloc = 8 * segs
    meta = np.zeros((n_alloc, 16), np.uint8)
    n = len(refs)
    meta[:n] = pack_meta(gstart, np.array([e0 for _, e0, _ in items]),
                         np.array([ne for _, _, ne in items]),
                         np.array([len(w) for w in refs]),
                         np.full(n, meth), np.zeros(n, np.int32))
    p_stay = 1.0 - 1.0 / epb
    read_tab = np.zeros((8, 8), np.float32)
    read_tab[:, 2] = 1.0
    read_tab[0, :6] = (sc.scale, sc.shift, sc.var, np.log(p_stay),
                       np.log(1.0 - p_stay - HMM_P_SKIP - HMM_P_BAD), rc)
    packed = pack_codes(seq_codes(ref_concat + b"\0" * 8), pad_to=1 << 8)
    scores = hmm_forward_meta(
        jnp.asarray(meta), jnp.asarray(packed), jnp.asarray(read_tab),
        jnp.asarray(ev_pool), jnp.asarray(model.level_mean),
        jnp.asarray(model.level_stdv), jnp.asarray(model.level_log_stdv),
        SEG=seg, k=K, use_i16=True,
        pad_events=_ebucket(max(ne for _, _, ne in items)))
    ours = np.asarray(scores).reshape(-1)[:n]
    np.testing.assert_allclose(ours, truth, rtol=1e-4, atol=1e-3)
