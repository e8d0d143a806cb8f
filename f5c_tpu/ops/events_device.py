"""Event detection — on-device JAX op (SURVEY §7 step 3).

Batched re-expression of the scrappie-style detector (reference
src/events.c:222-513; oracle ops/events_ref.py) that runs entirely on
the accelerator:

- **exact prefix sums without float64**: the reference accumulates in
  f64, and those running sums are *exact* (a ~130 pA f32 signal of
  <=1M samples needs <=42 mantissa bits for the running sum and <=41
  for the sum of f32 squares, both under f64's 53).  The same exact
  values are computed here as two-float ("double-float") pairs with a
  2Sum `jax.lax.associative_scan` — exactness within 48 bits makes the
  combiner genuinely associative, so the parallel scan is safe and no
  x64 mode is needed;
- the two windowed Welch t-stat tracks are pure element-wise vector
  math over the scanned pairs, mirroring the reference's f32/f64
  rounding points (window sums exact, means/variances rounded to f32
  exactly where events.c:324-373 rounds);
- the two coupled peak detectors run as ONE `lax.scan` over samples
  carrying the (peak_pos, peak_value, valid, masked_to) state of every
  read in the batch simultaneously — the short detector's reset/mask
  coupling into the long one is applied within each step, in the
  reference's exact order;
- events (start, length, mean, stdv) are assembled on device from the
  emission stream (slot 2i = short detector, 2i+1 = long detector —
  the reference's k-ordered tie-break) with a cumsum + scatter
  compaction.

Precision note: two places replicate f64 arithmetic with two-float
equivalents whose final f32 rounding can differ from the reference's
double-then-float rounding on exact ties (~2^-29 per op).  The full
112-read fixture set detects bit-identical event boundaries and
statistics (tests/test_events_device.py); a divergence would surface
there first.

This op serves pipelines that keep the signal on the device; ``auto``
takes the host C++ detector whenever the native library is built, since
event means feed the host-side postalign/QC decode either way
(Pipeline._events_engine).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    DNA_PEAK_HEIGHT,
    DNA_THRESHOLD1,
    DNA_THRESHOLD2,
    DNA_WINDOW1,
    DNA_WINDOW2,
    RNA_PEAK_HEIGHT,
    RNA_THRESHOLD1,
    RNA_THRESHOLD2,
    RNA_WINDOW1,
    RNA_WINDOW2,
)

FLT_MAX = np.float32(np.finfo(np.float32).max)
FLT_TINY = np.float32(np.finfo(np.float32).tiny)


def _barrier(x):
    """Keep XLA's algebraic simplifier from folding the error-free
    transforms (x - (x - y) -> y destroys 2Sum/Veltkamp when the op
    graph is fused); an optimization_barrier is a runtime no-op."""
    return jax.lax.optimization_barrier(x)


def _two_sum(a, b):
    """Knuth 2Sum: s + err == a + b exactly."""
    s = _barrier(a + b)
    bv = _barrier(s - a)
    err = (a - (s - bv)) + (b - bv)
    return s, err


def _df_combine(x, y):
    """Double-float addition (associative for exactly-representable
    running sums; see module docstring)."""
    h1, l1 = x
    h2, l2 = y
    s, e = _two_sum(h1, h2)
    e = e + (l1 + l2)
    hi = _barrier(s + e)
    lo = e - (hi - s)
    return hi, lo


def _df_scan(v):
    """Inclusive exact prefix sum of f32 values along axis -1, as a
    (hi, lo) two-float pair."""
    return jax.lax.associative_scan(
        _df_combine, (v, jnp.zeros_like(v)), axis=-1)


def _df_sub(ah, al, bh, bl):
    """Exact difference of two exact two-float values (window sums)."""
    s, e = _two_sum(ah, -bh)
    e = e + (al - bl)
    hi = _barrier(s + e)
    lo = e - (hi - s)
    return hi, lo


def _df_val(h, l):
    """Collapse to f32 (the two-float is exact, hi is its f32 rounding
    only when lo==0; use hi+lo which rounds once)."""
    return h + l


def _two_prod(a, b):
    """Dekker/Veltkamp error-free f32 product: p + err == a*b exactly."""
    p = _barrier(a * b)
    c = jnp.float32(4097.0)          # 2^12 + 1 splits a 24-bit mantissa
    aa = _barrier(c * a)
    a_hi = _barrier(aa - (aa - a))
    a_lo = a - a_hi
    bb = _barrier(c * b)
    b_hi = _barrier(bb - (bb - b))
    b_lo = b - b_hi
    err = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, err


def _df_div_scalar(h, l, w):
    """Two-float / f32 scalar with one Newton correction: the pair
    (q0, q1) carries ~47 significant bits of the true quotient — enough
    that after the t-stat's catastrophic cancellation the final f32
    rounding matches the reference's f64 arithmetic."""
    q0 = h / w
    p, pe = _two_prod(q0, w)
    r = ((h - p) - pe) + l
    q1 = r / w
    return q0, q1


def _window_sums(ph, pl, w):
    """Exact sums over [i-w, i) and [i, i+w) for every i, from the
    inclusive scan pair (ph, pl); i runs over the padded axis."""
    B, S = ph.shape
    z = jnp.zeros((B, 1), jnp.float32)
    # exclusive prefix P[i] = sum of v[0..i-1]
    eh = jnp.concatenate([z, ph[:, :-1]], axis=1)
    el = jnp.concatenate([z, pl[:, :-1]], axis=1)

    def shifted(a, k):
        return jnp.concatenate([jnp.zeros((B, k), jnp.float32),
                                a[:, :-k]], axis=1) if k else a

    def fwd(a, k):
        return jnp.concatenate([a[:, k:],
                                jnp.tile(a[:, -1:], (1, k))], axis=1)

    s1h, s1l = _df_sub(eh, el, shifted(eh, w), shifted(el, w))
    s2h, s2l = _df_sub(fwd(eh, w), fwd(el, w), eh, el)
    return (s1h, s1l), (s2h, s2l)


def _tstat(sum_p, sumsq_p, lengths, w):
    """Windowed Welch t-stat track (events.c:324-373 rounding points)."""
    (s1h, s1l), (s2h, s2l) = _window_sums(*sum_p, w)
    (q1h, q1l), (q2h, q2l) = _window_sums(*sumsq_p, w)
    wf = jnp.float32(w)
    # oracle: mean1 = f32(f64_sum1 / w); corrected two-float division
    # then one rounding (ties with the double-then-float path ~2^-29)
    mean1 = _df_val(*_df_div_scalar(s1h, s1l, wf))
    sum2 = _df_val(s2h, s2l)                    # f32(f64 window sum)
    mean2 = sum2 / wf
    sumsq2 = _df_val(q2h, q2l)
    # cv = f64(sumsq1)/w - f64(mean1^2) + f64(f32(sumsq2/w)) - f64(mean2^2)
    # — the subtraction cancels ~13 bits, so the first term must carry
    # f64-like precision: keep the corrected quotient as a pair
    a_h, a_l = _df_div_scalar(q1h, q1l, wf)
    # each term is rounded to f32 before the f64-precision combination
    # (events.c:351-357); barriers stop FMA contraction into the sums
    b = _barrier(mean1 * mean1)
    c = _barrier(sumsq2 / wf)
    d = _barrier(mean2 * mean2)
    cv_h, cv_l = _df_sub(a_h, a_l, b, jnp.zeros_like(b))
    cv_h, cv_l = _df_combine((cv_h, cv_l), (c, jnp.zeros_like(c)))
    cv_h, cv_l = _df_sub(cv_h, cv_l, d, jnp.zeros_like(d))
    cv = jnp.maximum(_df_val(cv_h, cv_l), FLT_TINY)
    delta = mean2 - mean1
    t = jnp.abs(delta) / jnp.sqrt(cv / wf)
    # valid region [w, n-w) per read; elsewhere zero
    B, S = t.shape
    i = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
    n = lengths[:, None]
    return jnp.where((i >= w) & (i < n - w), t, jnp.float32(0.0))


def _peak_scan(t1, t2, lengths, p1, p2, w1, w2, peak_height):
    """The two coupled detectors as one lax.scan over samples.

    Returns (emit0, pos0, emit1, pos1) stacked over steps, each (S, B).
    Slot order within a step is short-then-long, matching the
    reference's k-ordered inner loop (events.c:384)."""
    B, S = t1.shape
    ph = jnp.float32(peak_height)
    th = (jnp.float32(p1), jnp.float32(p2))
    half = (w1 // 2, w2 // 2)

    def detector(i, v, st, thresh, whalf, active):
        pp, pv, val = st
        in_min = pp == -1
        # min-tracking branch
        cand = v - pv > ph          # elif: only when NOT (v < pv)
        pv_min = jnp.where(v < pv, v, jnp.where(cand, v, pv))
        pp_min = jnp.where(cand, i, jnp.int32(-1))
        # peak-tracking branch
        upd = v > pv
        pv_pk = jnp.where(upd, v, pv)
        pp_pk = jnp.where(upd, i, pp)
        val_pk = val | ((pv_pk - v > ph) & (pv_pk > thresh))
        emit = val_pk & ((i - pp_pk) > whalf)
        pos = pp_pk
        pp_pk2 = jnp.where(emit, jnp.int32(-1), pp_pk)
        pv_pk2 = jnp.where(emit, v, pv_pk)
        val_pk2 = val_pk & ~emit
        # select branch, gate inactive lanes (masked or padded)
        pp_n = jnp.where(in_min, pp_min, pp_pk2)
        pv_n = jnp.where(in_min, pv_min, pv_pk2)
        val_n = jnp.where(in_min, val, val_pk2)
        pp_n = jnp.where(active, pp_n, pp)
        pv_n = jnp.where(active, pv_n, pv)
        val_n = jnp.where(active, val_n, val)
        emit = emit & ~in_min & active
        # peak state BEFORE the emission reset (the trigger coupling
        # reads it): pp_pk/pv_pk when in peak mode
        trig_pp = jnp.where(in_min, pp, pp_pk)
        trig_pv = jnp.where(in_min, pv, pv_pk)
        trig_live = ~in_min & active
        return (pp_n, pv_n, val_n), emit, pos, trig_pp, trig_pv, trig_live

    def step(carry, xs):
        i, = xs["i"],
        v0, v1 = xs["t1"], xs["t2"]
        st0, st1, masked1 = carry
        n = lengths
        act0 = (i >= 1) & (i < n)           # det0's masked_to is always 0
        st0n, emit0, pos0, tpp, tpv, tlive = detector(
            i, v0, st0, th[0], half[0], act0)
        # short-detector trigger: resets + masks the long detector
        trig = tlive & (tpv > th[0])
        pp1, pv1, val1 = st1
        pp1 = jnp.where(trig, jnp.int32(-1), pp1)
        pv1 = jnp.where(trig, FLT_MAX, pv1)
        val1 = jnp.where(trig, False, val1)
        masked1 = jnp.where(trig, tpp + jnp.int32(w1), masked1)
        act1 = (masked1 < i) & (i < n)
        st1n, emit1, pos1, *_ = detector(
            i, v1, (pp1, pv1, val1), th[1], half[1], act1)
        return (st0n, st1n, masked1), (emit0, pos0, emit1, pos1)

    init_det = (jnp.full((B,), -1, jnp.int32),
                jnp.full((B,), FLT_MAX, jnp.float32),
                jnp.zeros((B,), bool))
    carry0 = (init_det, init_det, jnp.zeros((B,), jnp.int32))
    xs = {"i": jnp.arange(S, dtype=jnp.int32),
          "t1": t1.T, "t2": t2.T}
    _, ys = jax.lax.scan(step, carry0, xs)
    return ys          # each (S, B)


@functools.partial(jax.jit, static_argnames=("rna", "max_events"))
def detect_events_device(pa, lengths, rna: bool = False,
                         max_events: int | None = None):
    """Batched on-device event detection.

    ``pa``: (B, S) float32 pA signal, padded with anything past
    ``lengths``; ``lengths``: (B,) int32.  Returns (starts i32,
    lengths f32, means f32, stdvs f32) each (B, M) plus n_events (B,)
    — rows beyond a read's count are zero.
    """
    if rna:
        w1, w2 = RNA_WINDOW1, RNA_WINDOW2
        th1, th2 = RNA_THRESHOLD1, RNA_THRESHOLD2
        phh = RNA_PEAK_HEIGHT
    else:
        w1, w2 = DNA_WINDOW1, DNA_WINDOW2
        th1, th2 = DNA_THRESHOLD1, DNA_THRESHOLD2
        phh = DNA_PEAK_HEIGHT
    B, S = pa.shape
    M = max_events or (S // 2 + 2)
    pa = pa.astype(jnp.float32)
    lengths = lengths.astype(jnp.int32)
    i_bs = jax.lax.broadcasted_iota(jnp.int32, (B, S), 1)
    v = jnp.where(i_bs < lengths[:, None], pa, jnp.float32(0.0))
    sum_p = _df_scan(v)
    # the square is an f32 multiply in the reference (events.c:310);
    # the barrier keeps it from FMA-contracting into the scan's adds
    sumsq_p = _df_scan(_barrier(v * v))
    t1 = _tstat(sum_p, sumsq_p, lengths, w1)
    t2 = _tstat(sum_p, sumsq_p, lengths, w2)
    emit0, pos0, emit1, pos1 = _peak_scan(t1, t2, lengths, th1, th2,
                                          w1, w2, phh)
    # interleave the two detectors' emission streams in step order
    # (short first within a step), drop peaks at 0 or >= n, compact
    em = jnp.stack([emit0, emit1], axis=1).reshape(2 * S, B).T  # (B, 2S)
    po = jnp.stack([pos0, pos1], axis=1).reshape(2 * S, B).T
    keep = em & (po > 0) & (po < lengths[:, None])
    slot = jnp.cumsum(keep.astype(jnp.int32), axis=1) - 1
    n_peaks = jnp.where(keep, slot + 1, 0).max(axis=1, initial=0)
    r_idx = jax.lax.broadcasted_iota(jnp.int32, keep.shape, 0)
    peaks = jnp.zeros((B, M), jnp.int32)
    peaks = peaks.at[jnp.where(keep, r_idx, B),
                     jnp.where(keep, slot + 1, 0)].set(
        po, mode="drop")
    # `peaks` was scattered at slot+1, so row r reads as the BOUNDS
    # vector (0, p_1, .., p_np); bound np+1 is the read length.  Event j
    # spans [bounds[j], bounds[j+1]) in the emission order, exactly as
    # the reference appends them (events.c:466-513).
    n_events = n_peaks + 1
    j = jax.lax.broadcasted_iota(jnp.int32, (B, M), 1)
    bounds = peaks
    nxt = jnp.concatenate([bounds[:, 1:], jnp.zeros((B, 1), jnp.int32)],
                          axis=1)
    ends = jnp.where(j + 1 <= n_peaks[:, None], nxt, lengths[:, None])
    valid = j < n_events[:, None]
    starts = jnp.where(valid, bounds, 0)
    ends = jnp.where(valid, ends, 0)
    lens = (ends - starts).astype(jnp.float32)
    lens_safe = jnp.where(lens != 0, lens, jnp.float32(1.0))
    ph_, pl_ = sum_p
    qh_, ql_ = sumsq_p
    zcol = jnp.zeros((B, 1), jnp.float32)
    eh = jnp.concatenate([zcol, ph_], axis=1)      # exclusive, S+1
    el = jnp.concatenate([zcol, pl_], axis=1)
    qh = jnp.concatenate([zcol, qh_], axis=1)
    ql = jnp.concatenate([zcol, ql_], axis=1)

    def g(a, idx):
        return jnp.take_along_axis(a, idx, axis=1)

    sh, sl = _df_sub(g(eh, ends), g(el, ends), g(eh, starts),
                     g(el, starts))
    mean = _df_val(sh, sl) / lens_safe
    dh, dl = _df_sub(g(qh, ends), g(ql, ends), g(qh, starts),
                     g(ql, starts))
    var = _df_val(dh, dl) / lens_safe - mean * mean
    stdv = jnp.sqrt(jnp.maximum(var, jnp.float32(0.0)))
    zero = jnp.float32(0.0)
    return (jnp.where(valid, starts, 0),
            jnp.where(valid, lens, zero),
            jnp.where(valid, mean, zero),
            jnp.where(valid, stdv, zero),
            n_events.astype(jnp.int32))


def detect_events_batch(pas: list[np.ndarray], rna: bool = False,
                        eager: bool = False):
    """Host wrapper: detect a batch of variable-length pA signals on the
    device and return per-read ``(start i64, length f32, mean f32,
    stdv f32)`` tuples matching ``native.detect_events`` dtypes.

    Shapes are bucketed (S to 16 Ki samples, B to 8 reads) so repeated
    waves reuse the same compiled executable.  ``eager=True`` runs the
    op un-jitted (IEEE div/sqrt — bit-exact vs the oracle; the pipeline
    uses it on the CPU, where tests pin byte-identical outputs).
    """
    B = len(pas)
    S = max(int(p.shape[0]) for p in pas)
    S = -(-S // (1 << 14)) * (1 << 14)
    B_pad = -(-B // 8) * 8
    pad = np.zeros((B_pad, S), np.float32)
    lens = np.zeros(B_pad, np.int32)
    for i, p in enumerate(pas):
        pad[i, : p.shape[0]] = p
        lens[i] = p.shape[0]
    fn = detect_events_device.__wrapped__ if eager else detect_events_device
    starts, lengths, means, stdvs, n_ev = fn(
        jnp.asarray(pad), jnp.asarray(lens), rna=rna)
    n_ev = np.asarray(n_ev)
    M = S // 2 + 2                   # the op's static event capacity
    mx = min(max(int(n_ev[:B].max(initial=1)), 1), M)
    # one device-side slice per array: D2H moves only the used columns
    starts = np.asarray(starts[:, :mx])
    lengths = np.asarray(lengths[:, :mx])
    means = np.asarray(means[:, :mx])
    stdvs = np.asarray(stdvs[:, :mx])
    out = []
    for i in range(B):
        n = int(n_ev[i])
        if n > M:
            # pathological emission density: both detectors firing
            # often enough that peaks exceed the S//2+2 scatter
            # capacity, so columns past M were dropped on device.
            # Fall back to the exact oracle for this read (the host
            # C++ path sizes its peak buffer to n+2 and has no cap).
            from .events_ref import detect_events

            et = detect_events(pas[i], rna=rna)
            out.append((np.asarray(et.start, np.int64), et.length,
                        et.mean, et.stdv))
            continue
        out.append((starts[i, :n].astype(np.int64),
                    lengths[i, :n].copy(),
                    means[i, :n].copy(),
                    stdvs[i, :n].copy()))
    return out
