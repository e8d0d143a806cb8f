"""ABEA — batched JAX implementation (the plain XLA route).

Fixed-shape, batched adaptive banded event alignment:

- **fill**: one ``lax.scan`` over band steps, vmapped over the read batch.
  Carry = two previous band rows (padded to 128 lanes) + band lower-left
  coordinates.  Emits a per-step trace row (uint8 direction per lane) and
  the score of the last-kmer column, so the full score matrix never
  materialises (3 rolling rows, like the reference GPU kernel's shared
  memory window, src/align.cu:256-487).
- **backtrace**: vmapped ``lax.while_loop`` walking the trace from the best
  last-kmer event; emits aligned pairs (kmer_idx, event_idx) and the
  emission-sum QC.

All shapes are static: reads are padded to (E, K) bucket sizes; masking
handles per-read lengths.

``plan_launch`` + ``abea_align_xla`` form the launch contract shared with
the GPU kernel (``ops/abea_cuda.py``): batch-wide event/rank pools and
per-read metadata in; the ragged packed walk, its start event and its
length out.  ``ops/route.py`` picks the implementation per platform.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    ABEA_EPSILON_SKIP,
    ABEA_LP_TRIM_P,
    ABEA_MAX_GAP_THRESHOLD,
    ABEA_MIN_AVG_LOG_EMISSION,
    ALN_BANDWIDTH,
)

BW = ALN_BANDWIDTH          # 100 logical lanes
PAD = 128                    # padded lane count
NEG_INF = np.float32(-np.inf)
LOG_INV_SQRT_2PI = np.float32(-0.918938)

FROM_D, FROM_U, FROM_L = 0, 1, 2


class AbeaBatch(NamedTuple):
    """Padded device inputs for one ABEA batch.

    Per-read model levels are pre-gathered (kmer rank lookup happens once,
    outside the hot loop) and padded by PAD on both sides so band-relative
    dynamic slices never go out of bounds.
    """

    event_means: jnp.ndarray      # f32 [B, E + 2*PAD] (PAD-shifted)
    kmer_mean: jnp.ndarray        # f32 [B, K + 2*PAD]
    kmer_stdv: jnp.ndarray        # f32 [B, K + 2*PAD]
    kmer_log_stdv: jnp.ndarray    # f32 [B, K + 2*PAD]
    n_events: jnp.ndarray         # i32 [B]
    n_kmers: jnp.ndarray          # i32 [B]
    scale: jnp.ndarray            # f32 [B]
    shift: jnp.ndarray            # f32 [B]
    # transition log-probabilities, computed in double (src/align.c) and
    # carried as f32 (hi, lo) pairs: f32 [B, 2]
    lp_stay: jnp.ndarray          # log(1 - 1/(events_per_kmer+1))
    lp_step: jnp.ndarray
    lp_skip: jnp.ndarray
    lp_trim: jnp.ndarray


def split_double(x) -> np.ndarray:
    """float64 values -> f32 (hi, lo) pairs on a new last axis; hi + lo
    in exact arithmetic equals x to ~48 bits."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    return np.stack([hi, (x - hi.astype(np.float64)).astype(np.float32)],
                    axis=-1)


def transition_lps(ev_len, rk_len):
    """Per-read (lp_stay, lp_step) in double, as src/align.c computes
    them from the events-per-kmer ratio."""
    epk = (np.asarray(ev_len, np.float64)
           / np.maximum(np.asarray(rk_len, np.float64), 1.0))
    p_stay = 1.0 - 1.0 / (epk + 1.0)
    return np.log(p_stay), np.log(1.0 - ABEA_EPSILON_SKIP - p_stay)


LP_SKIP = split_double(np.log(ABEA_EPSILON_SKIP))
LP_TRIM = split_double(np.log(ABEA_LP_TRIM_P))


def make_batch(event_means_list, kmer_rank_list, model, pad_events=None,
               pad_kmers=None, scalings=None) -> AbeaBatch:
    """Host-side batch assembly from per-read arrays."""
    B = len(event_means_list)
    E = pad_events or max(int(e.shape[0]) for e in event_means_list)
    K = pad_kmers or max(int(k.shape[0]) for k in kmer_rank_list)
    ev = np.zeros((B, E + 2 * PAD), dtype=np.float32)
    km = np.zeros((B, K + 2 * PAD), dtype=np.float32)
    ks = np.ones((B, K + 2 * PAD), dtype=np.float32)
    kl = np.zeros((B, K + 2 * PAD), dtype=np.float32)
    n_ev = np.zeros(B, dtype=np.int32)
    n_km = np.zeros(B, dtype=np.int32)
    sc = np.ones(B, dtype=np.float32)
    sh = np.zeros(B, dtype=np.float32)
    for i, (e, kr) in enumerate(zip(event_means_list, kmer_rank_list)):
        ne, nk = e.shape[0], kr.shape[0]
        ev[i, PAD : PAD + ne] = e
        km[i, PAD : PAD + nk] = model.level_mean[kr]
        ks[i, PAD : PAD + nk] = model.level_stdv[kr]
        kl[i, PAD : PAD + nk] = model.level_log_stdv[kr]
        n_ev[i] = ne
        n_km[i] = nk
        if scalings is not None:
            sc[i] = scalings[i].scale
            sh[i] = scalings[i].shift
    lp_stay, lp_step = transition_lps(n_ev, n_km)
    return AbeaBatch(
        event_means=jnp.asarray(ev),
        kmer_mean=jnp.asarray(km),
        kmer_stdv=jnp.asarray(ks),
        kmer_log_stdv=jnp.asarray(kl),
        n_events=jnp.asarray(n_ev),
        n_kmers=jnp.asarray(n_km),
        scale=jnp.asarray(sc),
        shift=jnp.asarray(sh),
        lp_stay=jnp.asarray(split_double(lp_stay)),
        lp_step=jnp.asarray(split_double(lp_step)),
        lp_skip=jnp.asarray(np.tile(LP_SKIP, (B, 1))),
        lp_trim=jnp.asarray(np.tile(LP_TRIM, (B, 1))),
    )


# --- exact rounding of double-precision sums in f32 arithmetic ---------
#
# The oracle adds scores in double and rounds once to f32 on store
# (src/align.c:382-406).  Error-free transformations (Knuth's TwoSum,
# Dekker's product) carry the exact sum as an unevaluated f32 pair and
# round it once, so the XLA route reproduces those stores.  Compilers
# contract a*b+c into one fused multiply-add (XLA does on the CPU and the
# GPU); ``_rounded`` marks each product whose rounding matters.

def _rounded(x):
    """x, rounded to f32 before any following add: the NaN-guard select
    sits between the multiply and its consumer, so the pair cannot be
    contracted into a fused multiply-add."""
    return jnp.where(jnp.isnan(x), jnp.float32(0.0), x)


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _split(a):
    c = _rounded(jnp.float32(4097.0) * a)   # 2^12 + 1: Veltkamp split
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a, b):
    p = _rounded(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _expansion(terms):
    """Exact sum of f32 terms as (s, err): s + err, |err| <= ulp(s)."""
    s, err = terms[0], jnp.float32(0.0)
    for t in terms[1:]:
        s, e = _two_sum(s, t)
        err = err + e
    return s, err


def _round_sum(*terms):
    """f32 rounding of the exact sum; a -inf first term stays -inf."""
    s, err = _expansion(terms)
    return jnp.where(jnp.isfinite(s), s + err, s)


def _times_double(n, lp):
    """Exact n * (lp[0] + lp[1]) for integer-valued f32 n, as terms."""
    p, e = _two_prod(n, lp[0])
    return p, e, n * lp[1]


def _best_start(last_col, ll_event, ll_kmer, n_events, n_kmers, lp_trim):
    """Backtrace start band: the last-kmer cell's score plus the trim
    tail, (n_events - e) * lp_trim, compared in double-float precision;
    the first best over ascending bands (src/align.c:429-445).  Returns
    (band, start event, any valid)."""
    off_lc = (n_kmers - 1) - ll_kmer
    event_at_lc = ll_event - off_lc
    valid = ((event_at_lc >= 0) & (event_at_lc < n_events)
             & (off_lc >= 0) & (off_lc < BW) & (last_col > NEG_INF))
    k = (n_events - event_at_lc).astype(jnp.float32)
    s, err = _expansion((last_col, *_times_double(k, lp_trim)))
    s = jnp.where(valid, s, 0.0)
    hi = s + err
    lo = err - (hi - s)
    hi = jnp.where(valid, hi, NEG_INF)
    best_hi = jnp.max(hi)
    lo = jnp.where(hi == best_hi, lo, NEG_INF)
    band = jnp.argmax((hi == best_hi) & (lo == jnp.max(lo)))
    return band, event_at_lc[band], jnp.any(valid)


def _shift_row(row, s):
    """row'[j] = row[j + s] for s in {-1, 0, +1}, out-of-range -> -inf."""
    left = jnp.concatenate([row[1:], jnp.array([NEG_INF])])      # s=+1
    right = jnp.concatenate([jnp.array([NEG_INF]), row[:-1]])    # s=-1
    return jnp.where(s == 1, left, jnp.where(s == -1, right, row))


def _fill_single(ev, km, ks, kl, n_events, n_kmers, scale, shift,
                 lp_stay, lp_step, lp_skip, lp_trim, n_bands: int):
    """Band fill for one read; returns (trace [n_bands, PAD] u8,
    ll_event [n_bands] i32, ll_kmer [n_bands] i32,
    last_col_score [n_bands] f32)."""
    offsets = jnp.arange(PAD, dtype=jnp.int32)
    half = BW // 2

    ll_event0 = jnp.int32(half - 1)
    ll_kmer0 = jnp.int32(-1 - half)
    ll_event1 = ll_event0 + 1
    ll_kmer1 = ll_kmer0

    band0 = jnp.full(PAD, NEG_INF)
    band0 = band0.at[-1 - ll_kmer0].set(0.0)
    band1 = jnp.full(PAD, NEG_INF)
    first_trim_off = ll_event1
    band1 = band1.at[first_trim_off].set(lp_trim[0])
    trace1 = jnp.zeros(PAD, dtype=jnp.uint8).at[first_trim_off].set(FROM_U)

    def last_col_at(row, ll_e, ll_k):
        off = (n_kmers - 1) - ll_k
        valid = (off >= 0) & (off < BW)
        v = jnp.where(valid, row[jnp.clip(off, 0, PAD - 1)], NEG_INF)
        return v

    def step(carry, bi):
        prev, prev2, ll_e_prev, ll_k_prev, ll_e_prev2, ll_k_prev2 = carry
        ll = prev[0]
        ur = prev[BW - 1]
        both_ob = (ll == NEG_INF) & (ur == NEG_INF)
        right = jnp.where(both_ob, bi % 2 == 1, ll < ur)
        ll_e = jnp.where(right, ll_e_prev, ll_e_prev + 1)
        ll_k = jnp.where(right, ll_k_prev + 1, ll_k_prev)

        event_idx = ll_e - offsets          # per lane
        kmer_idx = ll_k + offsets

        # slice model levels at kmer_idx (PAD-shifted arrays)
        kstart = ll_k + PAD
        kmean = jax.lax.dynamic_slice(km, (kstart,), (PAD,))
        kstdv = jax.lax.dynamic_slice(ks, (kstart,), (PAD,))
        klog = jax.lax.dynamic_slice(kl, (kstart,), (PAD,))
        # events at ll_e - offset: reversed slice
        estart = ll_e - (PAD - 1) + PAD
        erow = jax.lax.dynamic_slice(ev, (estart,), (PAD,))[::-1]

        a = (erow - (_rounded(scale * kmean) + shift)) / kstdv
        lp_emission = (LOG_INV_SQRT_2PI - klog
                       + _rounded(jnp.float32(-0.5) * a * a))

        # shifts of previous rows (see band offset algebra in abea_ref)
        s_up = jnp.where(right, 1, 0).astype(jnp.int32)
        s_left = s_up - 1
        s_diag = (ll_k - ll_k_prev2) - 1    # in {-1, 0, +1}
        up = _shift_row(prev, s_up)
        left = _shift_row(prev, s_left)
        diag = _shift_row(prev2, s_diag)

        score_d = _round_sum(diag, lp_step[0], lp_step[1], lp_emission)
        score_u = _round_sum(up, lp_stay[0], lp_stay[1], lp_emission)
        score_l = _round_sum(left, lp_skip[0], lp_skip[1])

        max_s = score_d
        frm = jnp.full(PAD, FROM_D, dtype=jnp.uint8)
        max_s = jnp.maximum(max_s, score_u)
        frm = jnp.where(max_s == score_u, jnp.uint8(FROM_U), frm)
        max_s = jnp.maximum(max_s, score_l)
        frm = jnp.where(max_s == score_l, jnp.uint8(FROM_L), frm)

        # in-band mask: 0 <= kmer < n_kmers and 0 <= event < n_events
        valid = ((kmer_idx >= 0) & (kmer_idx < n_kmers)
                 & (event_idx >= 0) & (event_idx < n_events)
                 & (offsets < BW))
        row = jnp.where(valid, max_s, NEG_INF)
        frm = jnp.where(valid, frm, jnp.uint8(0))

        # trim column (kmer == -1)
        trim_off = -1 - ll_k
        trim_event = ll_e - trim_off
        trim_ok = ((trim_off >= 0) & (trim_off < BW)
                   & (trim_event >= 0) & (trim_event < n_events))
        trim_score = _round_sum(*_times_double(
            (trim_event + 1).astype(jnp.float32), lp_trim))
        row = jnp.where((offsets == trim_off) & trim_ok, trim_score, row)
        frm = jnp.where((offsets == trim_off) & trim_ok, jnp.uint8(FROM_U),
                        frm)

        lc = last_col_at(row, ll_e, ll_k)
        new_carry = (row, prev, ll_e, ll_k, ll_e_prev, ll_k_prev)
        return new_carry, (frm, ll_e, ll_k, lc)

    carry0 = (band1, band0, ll_event1, ll_kmer1, ll_event0, ll_kmer0)
    _, (traces, ll_es, ll_ks, lcs) = jax.lax.scan(
        step, carry0, jnp.arange(2, n_bands, dtype=jnp.int32))

    trace = jnp.concatenate([jnp.zeros((1, PAD), jnp.uint8), trace1[None],
                             traces], axis=0)
    ll_event = jnp.concatenate(
        [jnp.array([ll_event0, ll_event1], jnp.int32), ll_es])
    ll_kmer = jnp.concatenate(
        [jnp.array([ll_kmer0, ll_kmer1], jnp.int32), ll_ks])
    lc0 = last_col_at(band0, ll_event0, ll_kmer0)
    lc1 = last_col_at(band1, ll_event1, ll_kmer1)
    last_col = jnp.concatenate([jnp.array([lc0, lc1]), lcs])
    return trace, ll_event, ll_kmer, last_col


@functools.partial(jax.jit, static_argnames=("n_bands",))
def abea_fill(batch: AbeaBatch, n_bands: int):
    """Vmapped band fill. Returns trace [B, n_bands, PAD] u8,
    ll_event/ll_kmer [B, n_bands] i32, last_col [B, n_bands] f32."""
    f = jax.vmap(lambda *a: _fill_single(*a, n_bands=n_bands))
    return f(batch.event_means, batch.kmer_mean, batch.kmer_stdv,
             batch.kmer_log_stdv, batch.n_events, batch.n_kmers,
             batch.scale, batch.shift, batch.lp_stay, batch.lp_step,
             batch.lp_skip, batch.lp_trim)


def _backtrace_single(trace, ll_event, ll_kmer, last_col, ev, km, ks, kl,
                      n_events, n_kmers, scale, shift, lp_trim,
                      max_pairs: int):
    """Backtrace one read. Returns (pair_kmer, pair_event i32[max_pairs]
    stored in REVERSE path order, n_pairs, sum_emission f32, max_gap)."""
    # best start event: score at last-kmer column + trim penalty for the rest
    _, curr_event, any_valid = _best_start(last_col, ll_event, ll_kmer,
                                           n_events, n_kmers, lp_trim)
    curr_kmer = n_kmers - 1

    def emission_at(kmer_idx, event_idx):
        emean = ev[event_idx + PAD]
        gmean = scale * km[kmer_idx + PAD] + shift
        a = (emean - gmean) / ks[kmer_idx + PAD]
        return LOG_INV_SQRT_2PI - kl[kmer_idx + PAD] + jnp.float32(-0.5) * a * a

    def cond(st):
        k, e, n, *_ = st
        return (k >= 0) & (e >= 0) & (n < max_pairs)

    def body(st):
        k, e, n, sum_em, gap, max_gap, pk, pe = st
        pk = pk.at[n].set(k)
        pe = pe.at[n].set(e)
        sum_em = sum_em + emission_at(k, e)
        bi = (e + 1) + (k + 1)
        offset = ll_event[bi] - e
        f = trace[bi, offset]
        is_d = f == FROM_D
        is_u = f == FROM_U
        k = jnp.where(is_u, k, k - 1)
        e = jnp.where(is_d | is_u, e - 1, e)
        gap = jnp.where(is_d | is_u, 0, gap + 1)
        max_gap = jnp.maximum(max_gap, gap)
        return (k, e, n + 1, sum_em, gap, max_gap, pk, pe)

    pk0 = jnp.zeros(max_pairs, dtype=jnp.int32)
    pe0 = jnp.zeros(max_pairs, dtype=jnp.int32)
    init = (jnp.where(any_valid, curr_kmer, -1),
            jnp.where(any_valid, curr_event, -1),
            jnp.int32(0), jnp.float32(0.0), jnp.int32(0), jnp.int32(0),
            pk0, pe0)
    k, e, n, sum_em, gap, max_gap, pk, pe = jax.lax.while_loop(
        cond, body, init)

    avg = sum_em / jnp.maximum(n.astype(jnp.float32), 1.0)
    # spanned: first pair (reverse order: index n-1) kmer == 0,
    # last pair (index 0) kmer == n_kmers-1
    first_k = pk[jnp.maximum(n - 1, 0)]
    spanned = (n > 0) & (first_k == 0) & (pk[0] == n_kmers - 1)
    failed = ((avg < ABEA_MIN_AVG_LOG_EMISSION) | (~spanned)
              | (max_gap > ABEA_MAX_GAP_THRESHOLD) | (n == 0))
    return pk, pe, n, sum_em, max_gap, failed


@functools.partial(jax.jit, static_argnames=("max_pairs",))
def abea_backtrace(fill_out, batch: AbeaBatch, max_pairs: int):
    trace, ll_event, ll_kmer, last_col = fill_out
    f = jax.vmap(lambda *a: _backtrace_single(*a, max_pairs=max_pairs))
    return f(trace, ll_event, ll_kmer, last_col, batch.event_means,
             batch.kmer_mean, batch.kmer_stdv, batch.kmer_log_stdv,
             batch.n_events, batch.n_kmers, batch.scale, batch.shift,
             batch.lp_trim)


def align_batch(batch: AbeaBatch, n_bands: int, max_pairs: int):
    """Fill + backtrace; returns per-read (pairs reverse-ordered, counts,
    QC)."""
    fill_out = abea_fill(batch, n_bands)
    return abea_backtrace(fill_out, batch, max_pairs)


# --- compact-output backtrace --------------------------------------------
#
# The pairs arrays are huge ([B, E+K] i32 x2); instead of materialising
# pairs on device, emit the walk as 2-bit direction codes packed
# 4-per-byte plus the start cell.  The
# native postalign (f5c_decode_postalign) reconstructs the pairs while
# computing the base-to-event map, so the full pairs array never crosses
# the device boundary.

def _backtrace_packed_single(trace, ll_event, ll_kmer, last_col, ev,
                             kparams, n_events, n_kmers, scale, shift,
                             lp_trim, max_pairs: int):
    """Backtrace one read, compact output.

    Returns (dirs u8 [max_pairs] with values FROM_*, start_event i32,
    n_pairs i32, sum_emission f32, max_gap i32, failed bool).  The walk
    starts at (n_kmers-1, start_event); pair i (reverse path order) is
    reconstructed by applying dirs[0..i)."""
    _, start_event, any_valid = _best_start(last_col, ll_event, ll_kmer,
                                            n_events, n_kmers, lp_trim)

    def emission_at(kmer_idx, event_idx):
        # one 4-wide slice of the interleaved (mean, stdv, log_stdv, 0)
        # row instead of three separate gathers — the walk is gather-bound
        emean = ev[event_idx + PAD]
        p = jax.lax.dynamic_slice(kparams, (4 * (kmer_idx + PAD),), (4,))
        gmean = scale * p[0] + shift
        a = (emean - gmean) / p[1]
        return LOG_INV_SQRT_2PI - p[2] + jnp.float32(-0.5) * a * a

    n_bands_i = trace.shape[0]

    def cond(st):
        k, e, n, *_ = st
        return (k >= 0) & (e >= 0) & (n < max_pairs)

    def one_step(st):
        """One masked walk step (the walk is a strict serial dependence;
        several steps are unrolled per while iteration to amortise loop
        overhead)."""
        k, e, n, sum_em, gap, max_gap, last_k, dirs = st
        active = (k >= 0) & (e >= 0) & (n < max_pairs)
        ks_ = jnp.clip(k, 0, None)
        es_ = jnp.clip(e, 0, None)
        sum_em = sum_em + jnp.where(active, emission_at(ks_, es_), 0.0)
        last_k = jnp.where(active, k, last_k)
        bi = jnp.clip((es_ + 1) + (ks_ + 1), 0, n_bands_i - 1)
        offset = jnp.clip(ll_event[bi] - es_, 0, PAD - 1)
        f = trace[bi, offset].astype(jnp.uint8)
        # inactive lanes drop their write (OOB index) and freeze state
        dirs = dirs.at[jnp.where(active, n, max_pairs)].set(f, mode="drop")
        is_d = f == FROM_D
        is_u = f == FROM_U
        k = jnp.where(active, jnp.where(is_u, k, k - 1), k)
        e = jnp.where(active, jnp.where(is_d | is_u, e - 1, e), e)
        gap = jnp.where(active, jnp.where(is_d | is_u, 0, gap + 1), gap)
        max_gap = jnp.maximum(max_gap, gap)
        n = jnp.where(active, n + 1, n)
        return (k, e, n, sum_em, gap, max_gap, last_k, dirs)

    def body(st):
        for _ in range(16):
            st = one_step(st)
        return st

    dirs0 = jnp.zeros(max_pairs, dtype=jnp.uint8)
    init = (jnp.where(any_valid, n_kmers - 1, -1),
            jnp.where(any_valid, start_event, -1),
            jnp.int32(0), jnp.float32(0.0), jnp.int32(0), jnp.int32(0),
            jnp.int32(-1), dirs0)
    k, e, n, sum_em, gap, max_gap, last_k, dirs = jax.lax.while_loop(
        cond, body, init)

    avg = sum_em / jnp.maximum(n.astype(jnp.float32), 1.0)
    spanned = (n > 0) & (last_k == 0)
    failed = ((avg < ABEA_MIN_AVG_LOG_EMISSION) | (~spanned)
              | (max_gap > ABEA_MAX_GAP_THRESHOLD) | (n == 0))
    # pack 4 directions per byte (2 bits each, little-endian within byte)
    d4 = dirs.reshape(max_pairs // 4, 4).astype(jnp.int32)
    w = jnp.array([1, 4, 16, 64], dtype=jnp.int32)
    packed = jnp.sum(d4 * w[None, :], axis=1).astype(jnp.uint8)
    return packed, start_event, n, sum_em, max_gap, failed


@functools.partial(jax.jit, static_argnames=("max_pairs",))
def abea_backtrace_packed(fill_out, batch: AbeaBatch, max_pairs: int):
    """Compact backtrace over the batch; max_pairs must be divisible by
    4.  Returns (packed_dirs u8 [B, max_pairs//4], start_event i32 [B],
    n_pairs i32 [B], sum_emission f32 [B], max_gap i32 [B],
    failed bool [B])."""
    trace, ll_event, ll_kmer, last_col = fill_out
    B, KW = batch.kmer_mean.shape
    kparams = jnp.stack(
        [batch.kmer_mean, batch.kmer_stdv, batch.kmer_log_stdv,
         jnp.zeros_like(batch.kmer_mean)], axis=-1).reshape(B, 4 * KW)
    f = jax.vmap(lambda *a: _backtrace_packed_single(*a,
                                                     max_pairs=max_pairs))
    return f(trace, ll_event, ll_kmer, last_col, batch.event_means,
             kparams, batch.n_events, batch.n_kmers, batch.scale,
             batch.shift, batch.lp_trim)


def decode_packed_dirs(packed_row: np.ndarray, n: int, start_event: int,
                       n_kmers: int) -> np.ndarray:
    """NumPy fallback for native.decode_postalign's pair reconstruction:
    packed 2-bit walk -> ascending (kmer, event) pairs [n, 2]."""
    nb = (n + 3) // 4
    b = packed_row[:nb].astype(np.uint8)
    d = np.stack([(b >> 0) & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                 axis=1).reshape(-1)[:n]
    is_u = d == FROM_U
    is_d = d == FROM_D
    dk = np.where(is_u, 0, -1)
    de = np.where(is_u | is_d, -1, 0)
    ks = (n_kmers - 1) + np.concatenate([[0], np.cumsum(dk[:-1])])
    es = start_event + np.concatenate([[0], np.cumsum(de[:-1])])
    return np.stack([ks[::-1], es[::-1]], axis=1).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("E", "K"))
def expand_batch_device(ev_concat, ev_off, ev_len, rank_concat, rk_off,
                        rk_len, level_mean, level_stdv, level_log_stdv,
                        scale, shift, lp_stay, lp_step, lp_skip, lp_trim,
                        E: int, K: int) -> AbeaBatch:
    """Build the padded AbeaBatch on device from flat concatenated
    per-read arrays — the host ships ~4 bytes per event instead of the
    fully padded rows."""
    B = ev_off.shape[0]
    col_e = jnp.arange(E + 2 * PAD, dtype=jnp.int32)[None, :]
    src_e = ev_off[:, None] + (col_e - PAD)
    mask_e = (col_e >= PAD) & (col_e < PAD + ev_len[:, None])
    ev = jnp.where(mask_e,
                   ev_concat[jnp.clip(src_e, 0, ev_concat.shape[0] - 1)],
                   jnp.float32(0.0))
    col_k = jnp.arange(K + 2 * PAD, dtype=jnp.int32)[None, :]
    src_k = rk_off[:, None] + (col_k - PAD)
    mask_k = (col_k >= PAD) & (col_k < PAD + rk_len[:, None])
    rk = rank_concat[jnp.clip(src_k, 0, rank_concat.shape[0] - 1)].astype(
        jnp.int32)
    km = jnp.where(mask_k, level_mean[rk], jnp.float32(0.0))
    ks = jnp.where(mask_k, level_stdv[rk], jnp.float32(1.0))
    kl = jnp.where(mask_k, level_log_stdv[rk], jnp.float32(0.0))
    return AbeaBatch(
        event_means=ev, kmer_mean=km, kmer_stdv=ks, kmer_log_stdv=kl,
        n_events=ev_len.astype(jnp.int32), n_kmers=rk_len.astype(jnp.int32),
        scale=scale, shift=shift, lp_stay=lp_stay, lp_step=lp_step,
        lp_skip=lp_skip, lp_trim=lp_trim)


# --- launch contract shared by both routes ---------------------------------

META_I = ("ev_off", "ev_len", "rk_off", "rk_len", "band_off")
META_F = ("scale", "shift", "stay_hi", "stay_lo", "step_hi", "step_lo")


def _pow2(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class AbeaLaunch(NamedTuple):
    """Host-side plan of one ABEA launch (``plan_launch``)."""

    meta_i: np.ndarray      # i32 [Bp, 5], columns META_I
    meta_f: np.ndarray      # f32 [Bp, 6], columns META_F
    byte_off: np.ndarray    # i32 [Bp + 1]: read i's walk bytes
    E: int                  # padded event count (XLA route)
    K: int                  # padded kmer count (XLA route)
    n_trace_bands: int      # summed band bound (GPU route)
    cap: int                # ragged walk buffer bytes

    @property
    def sizes(self) -> tuple:
        """(padded reads, E, K, n_trace_bands, cap)."""
        return (self.meta_i.shape[0], self.E, self.K, self.n_trace_bands,
                self.cap)

    @property
    def statics(self) -> dict:
        return dict(E=self.E, K=self.K, n_trace_bands=self.n_trace_bands,
                    cap=self.cap)

    def trace_bytes(self, platform: str) -> int:
        """Device trace scratch of this launch on ``platform``."""
        if platform == "gpu":
            return 32 * self.n_trace_bands
        return self.meta_i.shape[0] * (self.E + self.K + 2) * PAD


def plan_launch(ev_off, ev_len, rk_off, rk_len, scale, shift,
                at_least: tuple | None = None) -> AbeaLaunch:
    """Per-read metadata for reads whose events/ranks live in batch-wide
    pools at ``ev_off``/``rk_off``.

    The read axis is padded to a power of two (>= 8) with empty reads
    (no events: they align nothing and cost nothing on the GPU) so
    compiled shapes repeat across launches; ``at_least`` (a ``sizes``
    tuple) raises every padded size (the mesh stacks per-device plans).
    lp_stay/lp_step are computed in double (src/align.c) and carried as
    f32 (hi, lo) pairs (``split_double``)."""
    ev_len = np.asarray(ev_len, np.int64)
    rk_len = np.asarray(rk_len, np.int64)
    B = ev_len.shape[0]
    floor = at_least or (0, 0, 0, 0, 0)
    Bp = max(_pow2(B, 8), floor[0])
    lp_stay, lp_step = transition_lps(ev_len, rk_len)
    bands = ev_len + rk_len + 2
    band_off = np.concatenate([[0], np.cumsum(bands)])
    meta_i = np.zeros((Bp, len(META_I)), np.int32)
    meta_i[:B, 0] = ev_off
    meta_i[:B, 1] = ev_len
    meta_i[:B, 2] = rk_off
    meta_i[:B, 3] = rk_len
    meta_i[:, 4] = band_off[-1]
    meta_i[:B, 4] = band_off[:-1]
    meta_f = np.zeros((Bp, len(META_F)), np.float32)
    meta_f[:, 0] = 1.0
    meta_f[:B, 0] = scale
    meta_f[:B, 1] = shift
    meta_f[:B, 2:4] = split_double(lp_stay)
    meta_f[:B, 4:6] = split_double(lp_step)
    byte_off = np.zeros(Bp + 1, np.int64)
    byte_off[1:B + 1] = np.cumsum((ev_len + rk_len + 3) // 4)
    byte_off[B + 1:] = byte_off[B]
    E = max(_pow2(int(ev_len.max(initial=1)), 256), floor[1])
    K = max(_pow2(int(rk_len.max(initial=1)), 256), floor[2])
    n_trace = max(_pow2(int(band_off[-1]), 1 << 14), floor[3])
    cap = max(_pow2(int(byte_off[-1]), 4096), floor[4])
    return AbeaLaunch(meta_i, meta_f, byte_off.astype(np.int32), E, K,
                      n_trace, cap)


@functools.partial(jax.jit, static_argnames=("cap",))
def compact_dirs(packed, off, cap: int):
    """Ragged-compact the packed dirs: read i's bytes live at
    flat[off[i] : off[i+1]].  ``off`` is the host-computed cumsum of
    per-read byte capacity ceil((n_events+n_kmers)/4); ``cap`` a bucketed
    static total."""
    B, W = packed.shape
    j = jnp.arange(cap, dtype=jnp.int32)
    rid = jnp.clip(jnp.searchsorted(off, j, side="right") - 1, 0, B - 1)
    col = jnp.clip(j - off[rid], 0, W - 1)
    return packed[rid, col]


@functools.partial(jax.jit, static_argnames=("E", "K", "n_trace_bands",
                                             "cap"))
def abea_align_xla(ev_pool, rk_pool, meta_i, meta_f, byte_off,
                   level_mean, level_stdv, level_log_stdv, *,
                   E: int, K: int, n_trace_bands: int, cap: int):
    """The plain-XLA route of the launch contract: expansion -> fill ->
    packed walk -> ragged compaction.  Returns (flat packed dirs [cap]
    u8, start_event [B] i32 (-1: no alignment), n_pairs [B] i32)."""
    del n_trace_bands
    B = meta_i.shape[0]
    batch = expand_batch_device(
        ev_pool, meta_i[:, 0], meta_i[:, 1], rk_pool, meta_i[:, 2],
        meta_i[:, 3], level_mean, level_stdv, level_log_stdv,
        meta_f[:, 0], meta_f[:, 1], meta_f[:, 2:4], meta_f[:, 4:6],
        jnp.tile(jnp.asarray(LP_SKIP), (B, 1)),
        jnp.tile(jnp.asarray(LP_TRIM), (B, 1)), E=E, K=K)
    fill_out = abea_fill(batch, E + K + 2)
    packed, start_e, n, *_ = abea_backtrace_packed(fill_out, batch, E + K)
    start_e = jnp.where(n > 0, start_e, -1)
    return compact_dirs(packed, byte_off, cap), start_e, n


def align_reads(impl, event_means, ranks, scalings, model):
    """Align whole reads through one launch of ``impl`` (a route of the
    launch contract); returns per read the ascending (kmer, event)
    pairs, or None where no alignment was found."""
    ev_len = np.array([e.shape[0] for e in event_means], np.int64)
    rk_len = np.array([r.shape[0] for r in ranks], np.int64)
    ev_off = np.concatenate([[0], np.cumsum(ev_len)[:-1]])
    rk_off = np.concatenate([[0], np.cumsum(rk_len)[:-1]])
    plan = plan_launch(ev_off, ev_len, rk_off, rk_len,
                       [s.scale for s in scalings],
                       [s.shift for s in scalings])
    flat, start_e, n = impl(
        jnp.asarray(np.concatenate(event_means).astype(np.float32)),
        jnp.asarray(np.concatenate(ranks).astype(np.int32)),
        jnp.asarray(plan.meta_i), jnp.asarray(plan.meta_f),
        jnp.asarray(plan.byte_off), jnp.asarray(model.level_mean),
        jnp.asarray(model.level_stdv), jnp.asarray(model.level_log_stdv),
        **plan.statics)
    flat, start_e, n = np.asarray(flat), np.asarray(start_e), np.asarray(n)
    off = plan.byte_off
    return [None if start_e[i] < 0 or n[i] == 0 else
            decode_packed_dirs(flat[off[i]:off[i + 1]], int(n[i]),
                               int(start_e[i]), int(rk_len[i]))
            for i in range(len(event_means))]
