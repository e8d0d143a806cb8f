"""Profile-HMM forward — batched JAX implementation (device path).

Scores many (sequence window, event window) work items at once: items are
padded to a (max_events, max_kmers) bucket and vmapped; each item is a
``lax.scan`` over event rows carrying the per-kmer M/B/K state vectors.

Design:
- the within-row KMER_SKIP chain (K_i depends on K_{i-1} of the same row)
  is a log-semiring linear recurrence; with a constant self-transition it
  reduces to ``K_i = i*lp_kk + logcumsumexp(c_i - i*lp_kk)``, computed with
  an associative scan so the row stays fully vectorised,
- soft-clip flank vectors have closed forms (geometric in row index), so
  nothing row-dependent is precomputed or gathered,
- emission parameters (model Gaussians per kmer) are gathered once per
  item before the scan.

Float32 throughout (the reference uses a 0.001-nat lookup-table logsum;
exact f32 logaddexp is strictly more accurate).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    HMM_BACKGROUND_EMISSION,
    HMM_P_BAD,
    HMM_P_SKIP,
    HMM_P_SKIP_SELF,
    TRANS_CLIP_SELF,
    TRANS_START_TO_CLIP,
)

NEG_INF = np.float32(-np.inf)
LOG_INV_SQRT_2PI = np.float32(-0.918938)

_LP_SC = float(np.log(TRANS_START_TO_CLIP))
_LP_NSC = float(np.log(1 - TRANS_START_TO_CLIP))
_LP_CS = float(np.log(TRANS_CLIP_SELF))
_LP_NCS = float(np.log(1 - TRANS_CLIP_SELF))
_BG = HMM_BACKGROUND_EMISSION
_LP_MK = float(np.log(HMM_P_SKIP))
_LP_MB = float(np.log(HMM_P_BAD))
_LP_KK = float(np.log(HMM_P_SKIP_SELF))
_LP_KM = float(np.log(1 - HMM_P_SKIP_SELF))
_LP_B3 = float(np.log((1.0 - HMM_P_BAD) / 3))  # bk / bm_next / bm_self
_LP_BB = float(np.log(HMM_P_BAD))


class HmmBatch(NamedTuple):
    """Padded device inputs for one HMM scoring batch of N work items."""

    gp_mean: jnp.ndarray       # f32 [N, K] scaled model means per kmer
    gp_inv_stdv: jnp.ndarray   # f32 [N, K] 1/(stdv*var)
    gp_log_stdv: jnp.ndarray   # f32 [N, K] log(stdv)+log(var)
    event_means: jnp.ndarray   # f32 [N, E] window events in ROW ORDER
    n_kmers: jnp.ndarray       # i32 [N]
    n_events: jnp.ndarray      # i32 [N]
    lp_stay: jnp.ndarray       # f32 [N] log(1 - 1/events_per_base)
    lp_step: jnp.ndarray       # f32 [N] log(1 - p_stay - p_skip - p_bad)


def make_hmm_batch(items, event_means_per_item, model, scalings,
                   events_per_base, pad_events: int, pad_kmers: int
                   ) -> HmmBatch:
    """Host-side assembly.

    ``items``: HmmWorkItem list; ``event_means_per_item``: the read's full
    event-mean array per item; events are materialised into row order
    (following event_stride) so the device scan is a plain row walk.
    """
    from .hmm_ref import window_kmer_ranks

    N = len(items)
    gp_mean = np.zeros((N, pad_kmers), dtype=np.float32)
    gp_inv = np.ones((N, pad_kmers), dtype=np.float32)
    gp_log = np.zeros((N, pad_kmers), dtype=np.float32)
    ev = np.zeros((N, pad_events), dtype=np.float32)
    n_km = np.zeros(N, dtype=np.int32)
    n_ev = np.zeros(N, dtype=np.int32)
    lp_stay = np.zeros(N, dtype=np.float32)
    lp_step = np.zeros(N, dtype=np.float32)
    for i, it in enumerate(items):
        ranks = window_kmer_ranks(it.seq, it.rc_seq, it.rc, model)
        nk = ranks.shape[0]
        sc = scalings[i]
        var32 = np.float32(sc.var)
        gp_mean[i, :nk] = (np.float32(sc.scale) * model.level_mean[ranks]
                           + np.float32(sc.shift))
        stdv = model.level_stdv[ranks] * var32
        gp_inv[i, :nk] = 1.0 / stdv
        gp_log[i, :nk] = model.level_log_stdv[ranks] + np.log(var32)
        ne = abs(it.event_stop_idx - it.event_start_idx) + 1
        idx = it.event_start_idx + np.arange(ne) * it.event_stride
        ev[i, :ne] = event_means_per_item[i][idx]
        n_km[i] = nk
        n_ev[i] = ne
        epb = events_per_base[i]
        p_stay = 1 - 1 / epb
        lp_stay[i] = np.log(p_stay)
        lp_step[i] = np.log(1.0 - p_stay - HMM_P_SKIP - HMM_P_BAD)
    return HmmBatch(
        gp_mean=jnp.asarray(gp_mean), gp_inv_stdv=jnp.asarray(gp_inv),
        gp_log_stdv=jnp.asarray(gp_log), event_means=jnp.asarray(ev),
        n_kmers=jnp.asarray(n_km), n_events=jnp.asarray(n_ev),
        lp_stay=jnp.asarray(lp_stay), lp_step=jnp.asarray(lp_step),
    )


def _pre_flank(row_minus_1):
    """pre_flank[i], closed form (hmm_ref.make_flanks)."""
    i = row_minus_1.astype(jnp.float32)
    first = jnp.float32(_LP_NSC)
    rest = (jnp.float32(_LP_SC + _BG + _LP_NCS)
            + (i - 1) * jnp.float32(_LP_CS + _BG))
    return jnp.where(row_minus_1 == 0, first, rest)


def _post_flank(row_minus_1, n_events):
    i = row_minus_1.astype(jnp.float32)
    ne = n_events.astype(jnp.float32)
    last = jnp.float32(_LP_NSC)
    rest = (jnp.float32(_LP_SC + _BG + _LP_NCS)
            + (ne - 2 - i) * jnp.float32(_LP_CS + _BG))
    return jnp.where(row_minus_1 == n_events - 1, last, rest)


def _logaddexp(a, b):
    m = jnp.maximum(a, b)
    d = -jnp.abs(a - b)
    out = m + jnp.log1p(jnp.exp(d))
    return jnp.where(jnp.isneginf(m), NEG_INF, out)


def _logcumsumexp_chain(c, lp_kk):
    """K_i = logsum(c_i, K_{i-1} + lp_kk), vectorised.

    With a constant self-transition g the recurrence has the closed form
    K_i = i*g + logcumsumexp(c_j - j*g).  Renormalising by the global max
    keeps everything in f32 range; terms more than ~88 nats below the max
    underflow to zero, which is far below the scorer's numeric noise floor
    (the reference's table logsum truncates at 15.7 nats).
    """
    idx = jnp.arange(c.shape[0], dtype=jnp.float32)
    d = c - idx * lp_kk
    m = jnp.max(d)
    m_safe = jnp.where(jnp.isneginf(m), jnp.float32(0.0), m)
    s = jnp.cumsum(jnp.exp(d - m_safe))
    out = idx * lp_kk + jnp.log(s) + m_safe
    return jnp.where(s > 0, out, NEG_INF)


def _shift_prev(x):
    return jnp.concatenate([jnp.full((1,), NEG_INF), x[:-1]])


def _forward_single(gp_mean, gp_inv, gp_log, ev, n_kmers, n_events,
                    lp_stay, lp_step, allow_pre: bool, allow_post: bool,
                    pad_events: int):
    K_pad = gp_mean.shape[0]
    kidx = jnp.arange(K_pad)
    last_k = n_kmers - 1

    def step(carry, row_minus_1):
        M, B, K, lp_end = carry
        e = ev[row_minus_1]
        a = (e - gp_mean) * gp_inv
        lp_em = LOG_INV_SQRT_2PI - gp_log + jnp.float32(-0.5) * a * a

        Mp = _shift_prev(M)
        Bp = _shift_prev(B)
        Kp = _shift_prev(K)

        # single logsumexp over the 5 incoming terms (3 transcendentals
        # instead of ~8 nested logaddexp ones)
        t0 = lp_stay + M
        t1 = lp_step + Mp
        t2 = jnp.float32(_LP_B3) + B
        t3 = jnp.float32(_LP_B3) + Bp
        t4 = jnp.float32(_LP_KM) + Kp
        mx = jnp.maximum(jnp.maximum(jnp.maximum(t0, t1),
                                     jnp.maximum(t2, t3)), t4)
        mx_s = jnp.where(jnp.isneginf(mx), jnp.float32(0.0), mx)
        ssum = (jnp.exp(t0 - mx_s) + jnp.exp(t1 - mx_s)
                + jnp.exp(t2 - mx_s) + jnp.exp(t3 - mx_s)
                + jnp.exp(t4 - mx_s))
        m_new = jnp.where(jnp.isneginf(mx), NEG_INF,
                          mx_s + jnp.log(ssum))
        pre = _pre_flank(row_minus_1)
        soft_ok = allow_pre or (row_minus_1 == 0)
        m_new = jnp.where((kidx == 0) & soft_ok,
                          _logaddexp(m_new, pre), m_new)
        m_new = m_new + lp_em

        b_new = _logaddexp(_LP_MB + M, _LP_BB + B)

        c = _logaddexp(_LP_MK + _shift_prev(m_new),
                       _LP_B3 + _shift_prev(b_new))
        k_new = _logcumsumexp_chain(c, jnp.float32(_LP_KK))

        active = row_minus_1 < n_events
        M = jnp.where(active, m_new, M)
        B = jnp.where(active, b_new, B)
        K = jnp.where(active, k_new, K)

        do_end = active & (allow_post | (row_minus_1 == n_events - 1))
        pf = _post_flank(row_minus_1, n_events)
        end_add = _logaddexp(_logaddexp(M[last_k], B[last_k]), K[last_k]) + pf
        lp_end = jnp.where(do_end, _logaddexp(lp_end, end_add), lp_end)
        return (M, B, K, lp_end), None

    init = (jnp.full(K_pad, NEG_INF), jnp.full(K_pad, NEG_INF),
            jnp.full(K_pad, NEG_INF), NEG_INF)
    (M, B, K, lp_end), _ = jax.lax.scan(
        step, init, jnp.arange(pad_events, dtype=jnp.int32))
    return lp_end


@functools.partial(jax.jit,
                   static_argnames=("allow_pre", "allow_post", "pad_events"))
def hmm_forward_batch(batch: HmmBatch, pad_events: int,
                      allow_pre: bool = True, allow_post: bool = True):
    """Forward scores for every work item: f32 [N]."""
    f = jax.vmap(lambda *a: _forward_single(
        *a, allow_pre=allow_pre, allow_post=allow_post,
        pad_events=pad_events))
    return f(batch.gp_mean, batch.gp_inv_stdv, batch.gp_log_stdv,
             batch.event_means, batch.n_kmers, batch.n_events,
             batch.lp_stay, batch.lp_step)


SEG = 32          # lanes per packed window
SEGS = 4          # windows per 128-lane row


@functools.partial(jax.jit,
                   static_argnames=("pad_events", "allow_pre", "allow_post"))
def hmm_forward_packed4(ranks, n_kmers, ev_concat, ev_start, ev_stride,
                        n_events, scale, shift, var, lp_stay, lp_step,
                        level_mean, level_stdv, level_log_stdv,
                        pad_events: int, allow_pre: bool = True,
                        allow_post: bool = True):
    """Forward scores with FOUR windows packed per 128-lane row.

    Most CpG-group windows are ~16-26 kmers; giving each its own 128-lane
    row wastes 6/8 of the VPU.  Here windows of <= 32 kmers occupy 32-lane
    segments: the within-row shifts mask the segment boundaries, and the
    KMER_SKIP chain's log-cumsum-exp is segmented by subtracting the
    global running sum at each boundary (exact — every term is scaled by
    its own segment's max).

    Shapes: ranks [N, 128] (4 windows' ranks at lanes 32w..32w+31); all
    per-window scalars [N, 4].  Returns scores f32 [N, 4].
    """
    N = ranks.shape[0]
    lane = jnp.arange(SEG * SEGS, dtype=jnp.int32)[None, :]
    kseg = lane % SEG                       # kmer index within the window

    def rep(x):
        """[N, 4] -> [N, 128] per-segment broadcast."""
        return jnp.repeat(x, SEG, axis=1)

    r = ranks.astype(jnp.int32)
    scale_l = rep(scale)
    shift_l = rep(shift)
    var_l = rep(var)
    gp_mean = scale_l * level_mean[r] + shift_l
    sd = level_stdv[r] * var_l
    gp_inv = jnp.float32(1.0) / sd
    gp_log = level_log_stdv[r] + jnp.log(var_l)
    n_k_l = rep(n_kmers)
    n_ev_l = rep(n_events)
    lp_stay_l = rep(lp_stay)
    lp_step_l = rep(lp_step)
    in_window = kseg < n_k_l
    last_k = kseg == (n_k_l - 1)

    def shift_prev(x):
        rolled = jnp.concatenate(
            [jnp.full((N, 1), NEG_INF), x[:, :-1]], axis=1)
        return jnp.where(kseg == 0, NEG_INF, rolled)

    def seg_max(x):
        return rep(jnp.max(x.reshape(N, SEGS, SEG), axis=-1))

    def seg_prefix(x):
        """Global cumsum value at the previous segment boundary."""
        b = x.reshape(N, SEGS, SEG)[:, :, SEG - 1]       # [N, 4]
        p = jnp.concatenate([jnp.zeros((N, 1), x.dtype), b[:, :-1]],
                            axis=1)
        return rep(p)

    def step(carry, row_minus_1):
        M, B, K, lp_end = carry
        e4 = ev_concat[jnp.clip(ev_start + row_minus_1 * ev_stride, 0,
                                ev_concat.shape[0] - 1)]
        e = rep(e4)
        a = (e - gp_mean) * gp_inv
        lp_em = LOG_INV_SQRT_2PI - gp_log + jnp.float32(-0.5) * a * a

        Mp = shift_prev(M)
        Bp = shift_prev(B)
        Kp = shift_prev(K)

        t0 = lp_stay_l + M
        t1 = lp_step_l + Mp
        t2 = jnp.float32(_LP_B3) + B
        t3 = jnp.float32(_LP_B3) + Bp
        t4 = jnp.float32(_LP_KM) + Kp
        mx = jnp.maximum(jnp.maximum(jnp.maximum(t0, t1),
                                     jnp.maximum(t2, t3)), t4)
        mx_s = jnp.where(jnp.isneginf(mx), jnp.float32(0.0), mx)
        ssum = (jnp.exp(t0 - mx_s) + jnp.exp(t1 - mx_s)
                + jnp.exp(t2 - mx_s) + jnp.exp(t3 - mx_s)
                + jnp.exp(t4 - mx_s))
        m_new = jnp.where(jnp.isneginf(mx), NEG_INF, mx_s + jnp.log(ssum))
        pre = _pre_flank(row_minus_1)
        soft_ok = allow_pre or (row_minus_1 == 0)
        m_new = jnp.where((kseg == 0) & soft_ok,
                          _logaddexp(m_new, pre), m_new)
        m_new = m_new + lp_em

        b_new = _logaddexp(jnp.float32(_LP_MB) + M,
                           jnp.float32(_LP_BB) + B)

        # segmented kmer-skip chain; out-of-window lanes are masked BEFORE
        # the chain — their garbage values would otherwise dominate the
        # segment max and the cross-segment prefix subtraction would
        # cancel the (then denormal-tiny) valid terms catastrophically
        c = _logaddexp(jnp.float32(_LP_MK) + shift_prev(m_new),
                       jnp.float32(_LP_B3) + shift_prev(b_new))
        c = jnp.where(in_window, c, NEG_INF)
        g = jnp.float32(_LP_KK)
        d = c - kseg.astype(jnp.float32) * g
        m_seg = seg_max(d)
        m_safe = jnp.where(jnp.isneginf(m_seg), jnp.float32(0.0), m_seg)
        e_seg = jnp.exp(d - m_safe)
        s_seg = jnp.cumsum(e_seg.reshape(N, SEGS, SEG),
                           axis=-1).reshape(N, SEGS * SEG)
        k_new = jnp.where(s_seg > 0,
                          kseg.astype(jnp.float32) * g + jnp.log(s_seg)
                          + m_safe, NEG_INF)

        active = row_minus_1 < n_ev_l
        M = jnp.where(active, m_new, M)
        B = jnp.where(active, b_new, B)
        K = jnp.where(active, k_new, K)

        do_end = active & (allow_post | (row_minus_1 == n_ev_l - 1))
        pf = _post_flank(row_minus_1, n_ev_l)
        end_add = _logaddexp(_logaddexp(M, B), K) + pf
        lp_end = jnp.where(do_end & last_k & in_window,
                           _logaddexp(lp_end, end_add), lp_end)
        return (M, B, K, lp_end), None

    shape = (N, SEG * SEGS)
    init = (jnp.full(shape, NEG_INF), jnp.full(shape, NEG_INF),
            jnp.full(shape, NEG_INF), jnp.full(shape, NEG_INF))
    (M, B, K, lp_end), _ = jax.lax.scan(
        step, init, jnp.arange(pad_events, dtype=jnp.int32))
    # only each window's last-kmer lane accumulated; others stayed -inf
    return jnp.max(lp_end.reshape(N, SEGS, SEG), axis=-1)


# --- Viterbi (eventalign re-alignment) -------------------------------------
#
# Same 3-state-per-kmer profile HMM in the max-plus semiring, plus movement
# tracking for the backtrace (reference src/hmm.c:313-533 with the
# ProfileHMMViterbiOutputR9 policy; oracle ops/hmm_ref.profile_hmm_viterbi).
# hmm_flags = 0 (eventalign.c:765): no pre/post soft clip, so the start
# transition is only allowed into row 1 and the backtrace starts at the
# fixed cell (last event row, MATCH state of the last kmer).

HMT_FROM_SAME_M = 0
HMT_FROM_PREV_M = 1
HMT_FROM_SAME_B = 2
HMT_FROM_PREV_B = 3
HMT_FROM_PREV_K = 4
HMT_FROM_SOFT = 5

# next profile state per movement code: M, M, B, B, K
_NEXT_PS = (2, 2, 1, 1, 0)


def _viterbi_single(gp_mean, gp_inv, gp_log, ev_window, n_kmers, n_events,
                    lp_stay, lp_step, pad_events: int, max_path: int):
    """One Viterbi fill + backtrace; returns (movements u8 [max_path],
    n_steps).  Movements are the reference's HMT codes along the walk from
    (row=n_events, kmer=n_kmers-1, state=M); the host reconstructs
    (event_idx, kmer_idx, state) from them."""
    K_pad = gp_mean.shape[0]
    kidx = jnp.arange(K_pad)
    LP_SM = jnp.float32(0.0)
    PRE0 = jnp.float32(_LP_NSC)   # pre_flank[0]

    def step(carry, row_minus_1):
        M, B, K = carry
        e = ev_window[row_minus_1]
        a = (e - gp_mean) * gp_inv
        lp_em = LOG_INV_SQRT_2PI - gp_log + jnp.float32(-0.5) * a * a

        Mp = _shift_prev(M)
        Bp = _shift_prev(B)
        Kp = _shift_prev(K)

        # MATCH: last equal index wins (hmm.c update_cell tie rule)
        s0 = lp_stay + M                      # FROM_SAME_M
        s1 = lp_step + Mp                     # FROM_PREV_M
        s2 = jnp.float32(_LP_B3) + B          # FROM_SAME_B
        s3 = jnp.float32(_LP_B3) + Bp         # FROM_PREV_B
        s4 = jnp.float32(_LP_KM) + Kp         # FROM_PREV_K
        s5 = jnp.where((kidx == 0) & (row_minus_1 == 0),
                       LP_SM + PRE0, NEG_INF)  # FROM_SOFT (row 1 only)
        mx = jnp.maximum(jnp.maximum(jnp.maximum(s0, s1),
                                     jnp.maximum(s2, s3)),
                         jnp.maximum(s4, s5))
        frm_m = jnp.zeros(K_pad, dtype=jnp.uint8)
        for i, s in enumerate((s1, s2, s3, s4, s5)):
            frm_m = jnp.where(s == mx, jnp.uint8(i + 1), frm_m)
        m_new = mx + lp_em

        # BAD_EVENT (emission 0): SAME_B wins ties over SAME_M
        b_m = jnp.float32(_LP_MB) + M
        b_b = jnp.float32(_LP_BB) + B
        b_new = jnp.maximum(b_m, b_b)
        frm_b = jnp.where(b_b == b_new, jnp.uint8(HMT_FROM_SAME_B),
                          jnp.uint8(HMT_FROM_SAME_M))

        # KMER_SKIP chain within the row (max-plus linear recurrence):
        # K_i = max(c_i, K_{i-1} + lp_kk), closed form via cummax
        c = jnp.maximum(jnp.float32(_LP_MK) + _shift_prev(m_new),
                        jnp.float32(_LP_B3) + _shift_prev(b_new))
        g = jnp.float32(_LP_KK)
        i_f = kidx.astype(jnp.float32)
        d = c - i_f * g
        m_run = jax.lax.cummax(d)
        k_new = i_f * g + m_run
        # movement ties (PREV_K > PREV_B > PREV_M) decided in d-space,
        # where the chain-vs-fresh comparison is exact: the chain wins
        # iff the running max predates this column (>= on ties)
        from_chain = _shift_prev(m_run) >= d
        from_b = (jnp.float32(_LP_B3) + _shift_prev(b_new)) == c
        frm_k = jnp.where(from_chain, jnp.uint8(HMT_FROM_PREV_K),
                          jnp.where(from_b, jnp.uint8(HMT_FROM_PREV_B),
                                    jnp.uint8(HMT_FROM_PREV_M)))

        active = row_minus_1 < n_events
        M = jnp.where(active, m_new, M)
        B = jnp.where(active, b_new, B)
        K = jnp.where(active, k_new, K)
        movs = jnp.stack([frm_k, frm_b, frm_m])   # [3, K_pad], PSR9 order
        return (M, B, K), movs

    init = (jnp.full(K_pad, NEG_INF), jnp.full(K_pad, NEG_INF),
            jnp.full(K_pad, NEG_INF))
    _, bm = jax.lax.scan(step, init,
                         jnp.arange(pad_events, dtype=jnp.int32))
    # bm: [pad_events, 3, K_pad] — bm[row-1, ps, kmer]

    next_ps = jnp.array(_NEXT_PS + (0,), dtype=jnp.int32)

    def cond(st):
        row, kmer, ps, n, done = st[:5]
        return (row > 0) & (n < max_path) & (~done)

    def body(st):
        row, kmer, ps, n, done, out = st
        mv = bm[row - 1, ps, jnp.clip(kmer, 0, K_pad - 1)]
        out = out.at[n].set(mv)
        done = mv == HMT_FROM_SOFT
        mv_i = mv.astype(jnp.int32)
        dec_k = (mv_i == HMT_FROM_PREV_M) | (mv_i == HMT_FROM_PREV_B) | (
            mv_i == HMT_FROM_PREV_K)
        kmer = jnp.where(done, kmer, kmer - dec_k.astype(jnp.int32))
        row = jnp.where(done | (ps == 0), row, row - 1)
        ps = next_ps[jnp.clip(mv_i, 0, 5)]
        return (row, kmer, ps, n + 1, done, out)

    out0 = jnp.zeros(max_path, dtype=jnp.uint8)
    st = (n_events, n_kmers - 1, jnp.int32(2), jnp.int32(0),
          jnp.bool_(False), out0)
    row, kmer, ps, n, done, out = jax.lax.while_loop(cond, body, st)
    return out, n


@functools.partial(jax.jit,
                   static_argnames=("pad_events", "max_path"))
def hmm_viterbi_packed(ranks, n_kmers, ev_concat, ev_start, ev_stride,
                       n_events, scale, shift, var, lp_stay, lp_step,
                       level_mean, level_stdv, level_log_stdv,
                       pad_events: int, max_path: int):
    """Batched Viterbi with device-side input assembly (same compact
    contract as hmm_forward_packed).  Returns (movements u8 [N, max_path],
    n_steps i32 [N])."""
    r = ranks.astype(jnp.int32)
    gp_mean = scale[:, None] * level_mean[r] + shift[:, None]
    sd = level_stdv[r] * var[:, None]
    gp_inv = jnp.float32(1.0) / sd
    gp_log = level_log_stdv[r] + jnp.log(var)[:, None]
    rows = jnp.arange(pad_events, dtype=jnp.int32)
    idx = ev_start[:, None] + rows[None, :] * ev_stride[:, None]
    idx = jnp.clip(idx, 0, ev_concat.shape[0] - 1)
    ev = ev_concat[idx]
    f = jax.vmap(lambda *a: _viterbi_single(*a, pad_events=pad_events,
                                            max_path=max_path))
    return f(gp_mean, gp_inv, gp_log, ev, n_kmers, n_events, lp_stay,
             lp_step)


@functools.partial(jax.jit,
                   static_argnames=("pad_events", "pad_k", "max_path"))
def hmm_viterbi_rounds(spec_i32, spec_f32, rank_pool, ev_pool,
                       level_mean, level_stdv, level_log_stdv,
                       pad_events: int, pad_k: int, max_path: int):
    """Lockstep-round Viterbi for eventalign: the per-read rank/event
    pools stay device-resident across rounds; each round ships only two
    small spec arrays and receives movements packed 2-per-byte.

    spec_i32 [N, 6]: rank_start, rank_stride, n_kmers, ev_start,
    ev_stride, n_events.  spec_f32 [N, 5]: scale, shift, var, lp_stay,
    lp_step.  Returns (packed movements u8 [N, max_path//2], n_steps).
    """
    rank_start = spec_i32[:, 0]
    rank_stride = spec_i32[:, 1]
    n_kmers = spec_i32[:, 2]
    ev_start = spec_i32[:, 3]
    ev_stride = spec_i32[:, 4]
    n_events = spec_i32[:, 5]
    scale = spec_f32[:, 0]
    shift = spec_f32[:, 1]
    var = spec_f32[:, 2]
    lp_stay = spec_f32[:, 3]
    lp_step = spec_f32[:, 4]

    cols = jnp.arange(pad_k, dtype=jnp.int32)
    ridx = rank_start[:, None] + cols[None, :] * rank_stride[:, None]
    ridx = jnp.clip(ridx, 0, rank_pool.shape[0] - 1)
    r = rank_pool[ridx].astype(jnp.int32)
    r = jnp.where(cols[None, :] < n_kmers[:, None], r, 0)

    gp_mean = scale[:, None] * level_mean[r] + shift[:, None]
    sd = level_stdv[r] * var[:, None]
    gp_inv = jnp.float32(1.0) / sd
    gp_log = level_log_stdv[r] + jnp.log(var)[:, None]
    rows = jnp.arange(pad_events, dtype=jnp.int32)
    eidx = ev_start[:, None] + rows[None, :] * ev_stride[:, None]
    eidx = jnp.clip(eidx, 0, ev_pool.shape[0] - 1)
    ev = ev_pool[eidx]
    f = jax.vmap(lambda *a: _viterbi_single(*a, pad_events=pad_events,
                                            max_path=max_path))
    movs, n_steps = f(gp_mean, gp_inv, gp_log, ev, n_kmers, n_events,
                      lp_stay, lp_step)
    # pack two 3-bit movement codes per byte for the D2H copy
    m2 = movs.reshape(movs.shape[0], max_path // 2, 2)
    packed = (m2[..., 0] | (m2[..., 1] << 3)).astype(jnp.uint8)
    return packed, n_steps


def unpack_movements(packed_row: np.ndarray, n_steps: int) -> np.ndarray:
    """Host-side unpack of hmm_viterbi_rounds' 2-per-byte movements."""
    b = packed_row[: (n_steps + 1) // 2]
    out = np.empty(2 * b.shape[0], dtype=np.uint8)
    out[0::2] = b & 7
    out[1::2] = b >> 3
    return out[:n_steps]


def decode_viterbi_movements(movs: np.ndarray, n_steps: int, e_start: int,
                             event_stride: int, n_events: int,
                             n_kmers: int):
    """Reconstruct the reference's HMMAlignmentState list from the walk.

    Returns (event_idx, kmer_idx, state u8 0=K/1=B/2=M) arrays in FORWARD
    path order (the walk is reversed, eventalign.c:905).  Vectorised.
    """
    if n_steps == 0:
        z = np.zeros(0, np.int64)
        return z, z, z.astype(np.uint8)
    mv = movs[:n_steps].astype(np.int64)
    next_ps = np.array(_NEXT_PS + (0,), dtype=np.int64)
    # state at step i: ps_0 = M; ps_{i+1} = next_ps[mv_i]
    ps = np.empty(n_steps, dtype=np.int64)
    ps[0] = 2
    ps[1:] = next_ps[mv[:-1]]
    dec_k = ((mv == HMT_FROM_PREV_M) | (mv == HMT_FROM_PREV_B)
             | (mv == HMT_FROM_PREV_K)).astype(np.int64)
    kmer_idx = (n_kmers - 1) - (np.cumsum(dec_k) - dec_k)
    # row decrements when the visited state is not KMER_SKIP (silent)
    dec_r = (ps != 0).astype(np.int64)
    row = n_events - (np.cumsum(dec_r) - dec_r)
    event_idx = e_start + (row - 1) * event_stride
    return (event_idx[::-1].copy(), kmer_idx[::-1].copy(),
            ps[::-1].astype(np.uint8))


@functools.partial(jax.jit,
                   static_argnames=("pad_events", "allow_pre", "allow_post"))
def hmm_forward_packed(ranks, n_kmers, ev_concat, ev_start, ev_stride,
                       n_events, scale, shift, var, lp_stay, lp_step,
                       level_mean, level_stdv, level_log_stdv,
                       pad_events: int, allow_pre: bool = True,
                       allow_post: bool = True):
    """Forward scores with device-side input assembly.

    Compact inputs — per-item kmer ranks [N, K] (i16/i32), the batch's flat
    event pool, per-item window start/stride, and per-item calibration
    scalars — are expanded into the padded Gaussian tables and event
    windows on device (table gather + affine), so the host->device
    transfer is ~10x smaller than shipping the assembled f32 arrays.
    """
    r = ranks.astype(jnp.int32)
    gp_mean = scale[:, None] * level_mean[r] + shift[:, None]
    sd = level_stdv[r] * var[:, None]
    gp_inv = jnp.float32(1.0) / sd
    gp_log = level_log_stdv[r] + jnp.log(var)[:, None]
    # mask padding kmers (rank 0 in padding rows would otherwise produce
    # finite emissions; _forward_single masks by n_kmers, but keep the
    # gp rows harmless anyway)
    rows = jnp.arange(pad_events, dtype=jnp.int32)
    idx = ev_start[:, None] + rows[None, :] * ev_stride[:, None]
    idx = jnp.clip(idx, 0, ev_concat.shape[0] - 1)
    ev = ev_concat[idx]
    batch = HmmBatch(gp_mean=gp_mean, gp_inv_stdv=gp_inv, gp_log_stdv=gp_log,
                     event_means=ev, n_kmers=n_kmers, n_events=n_events,
                     lp_stay=lp_stay, lp_step=lp_step)
    return hmm_forward_batch(batch, pad_events, allow_pre=allow_pre,
                             allow_post=allow_post)
