"""Device-side assembly of the profile-HMM scorer inputs.

The scorer (ops/hmm.py: ``hmm_forward_packed4`` for windows of <= 32
kmers, ``hmm_forward_packed`` for <= 128) consumes per-window kmer ranks
plus nine per-window scalar arrays.  Shipping those from the host costs
~100 B per window (ranks alone are 2 B x SEG); but every input is a pure
function of
  - the batch's disambiguated reference segments (ACGT -> 2-bit packed,
    0.25 B/base),
  - a tiny per-read scalar table (scale/shift/var/lp_stay/lp_step/rc),
  - 16 bytes of per-window metadata,
so this module rebuilds them on device inside the scoring dispatch.

Rank semantics are pinned bit-for-bit to native f5c_hmm_window_ranks
(f5chost.cpp:1896; reference methylate meth.c:362-385 + meth-aware
revcomp meth.c:390-423):

- forward unmeth: rank[ki] = sum_j code5(ref[g+ki+j]) * 5^(k-1-j)
  with code5 = A0 C1 G2 M3 T4 (M never occurs unmethylated);
- forward meth: same over m[] = ref with C->M wherever the NEXT base is
  G.  methylate() is WINDOW-local in the reference: a C at the window's
  last position keeps C even when the genome continues with G.  On the
  global plane that C became M; the difference hits exactly one kmer
  (the window's last, at weight 5^0), fixed by subtracting 2;
- reverse strand walks revcomp_meth(window).  Algebraically the rank of
  rc-kmer ki equals sum_u val(g+ki+u) * 5^u (ascending genome order,
  REVERSED weights) where val(p) = G if m[p]==M; M if m[p]==G and
  m[p-1]==M; complement5(m[p]) otherwise.  The only window-edge
  discrepancy vs the global plane: an M immediately BEFORE the window
  makes the plane call the window's first G an M while revcomp_meth
  (window-local) complements it to C — again one kmer (the first, at
  weight 5^0), fixed by subtracting 2.

The packed reference must carry >= 1 trailing zero (A) sentinel byte so
the shifted adds never wrap a window across the buffer end (pack_seqs
zero-fills; the caller appends sentinel codes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

META_BYTES = 16
PAD = 128          # lanes per scorer row: 128 // SEG windows

# read_tab column layout (f32): scale shift var lp_stay lp_step rc - -
RT_SCALE, RT_SHIFT, RT_VAR, RT_LP_STAY, RT_LP_STEP, RT_RC = range(6)


def pack_meta(gstart, ev_start, n_ev_signed, wlen, meth, read_id):
    """Host: pack per-window int arrays into the (N, 16) u8 meta buffer.

    Layout (little-endian i32 words): [gstart][ev_start][n_ev * stride]
    [wlen | meth<<15 | read_id<<16].
    """
    n = gstart.shape[0]
    w = np.empty((n, 4), np.int32)
    w[:, 0] = gstart
    w[:, 1] = ev_start
    w[:, 2] = n_ev_signed
    w[:, 3] = (wlen.astype(np.int32)
               | (meth.astype(np.int32) << 15)
               | (read_id.astype(np.int32) << 16))
    return w.view(np.uint8)


def build_inputs(meta, packed_ref, read_tab,
                 SEG: int, k: int, use_i16: bool):
    """Traceable device-side assembly of the scorer inputs.

    Returns (ranks (n_rows, 128), n_km, ev_start, stride, n_ev, scale,
    shift, var, lp_stay, lp_step) with the per-window arrays shaped
    (n_rows, SEGS); the ranks are bit-identical to native
    hmm_window_ranks (tests/test_hmm_meta_ranks.py)."""
    SEGS = PAD // SEG
    n_alloc = meta.shape[0]
    n_rows = n_alloc // SEGS

    w = jax.lax.bitcast_convert_type(
        meta.reshape(n_alloc, 4, 4), jnp.int32)
    gstart = w[:, 0]
    ev_start = w[:, 1]
    nev_s = w[:, 2]
    w3 = w[:, 3]
    wlen = w3 & 0x7FFF
    meth = (w3 >> 15) & 1
    read_id = (w3 >> 16) & 0xFFFF
    stride = jnp.where(nev_s < 0, -1, 1).astype(jnp.int32)
    n_ev = jnp.abs(nev_s)
    n_km = wlen - (k - 1)          # <= 0 for padding items -> masked

    # ---- rank planes over the whole reference concat ----
    c = packed_ref.astype(jnp.int32)
    codes = jnp.stack([(c >> 0) & 3, (c >> 2) & 3,
                       (c >> 4) & 3, (c >> 6) & 3], axis=1).reshape(-1)
    P = codes.shape[0]
    c5 = codes + (codes == 3)                     # A0 C1 G2 T4
    nxt = jnp.roll(c5, -1)
    m5 = jnp.where((c5 == 1) & (nxt == 2), 3, c5)  # CG -> MG (global)
    comp_tab = jnp.array([4, 2, 1, 0, 0], jnp.int32)  # A<->T C<->G
    val_u = comp_tab[c5]
    prev_m = jnp.roll(m5, 1)
    val_m = jnp.where(m5 == 3, 2,
                      jnp.where((m5 == 2) & (prev_m == 3), 3,
                                comp_tab[jnp.where(m5 == 3, 0, m5)]))

    def plane_fwd(x):
        acc = x * (5 ** (k - 1))
        for j in range(1, k):
            acc = acc + jnp.roll(x, -j) * (5 ** (k - 1 - j))
        return acc

    def plane_rev(x):
        acc = x
        for u in range(1, k):
            acc = acc + jnp.roll(x, -u) * (5 ** u)
        return acc

    planes = jnp.concatenate([plane_fwd(c5), plane_fwd(m5),
                              plane_rev(val_u), plane_rev(val_m)])

    # ---- per-window rank gather + window-edge corrections ----
    rc = (read_tab[read_id, RT_RC] > 0).astype(jnp.int32)
    sel = meth + 2 * rc
    ki = jax.lax.broadcasted_iota(jnp.int32, (n_alloc, SEG), 1)
    pos = jnp.clip(gstart[:, None] + ki, 0, P - 1)
    ranks = jnp.take(planes, sel[:, None] * P + pos)

    gend = gstart + wlen - 1
    cg = lambda p: jnp.take(c5, jnp.clip(p, 0, P - 1))
    edge_f = ((meth == 1) & (rc == 0)
              & (cg(gend) == 1) & (cg(gend + 1) == 2))
    edge_r = ((meth == 1) & (rc == 1)
              & (cg(gstart - 1) == 1) & (cg(gstart) == 2))
    corr = (jnp.where(edge_f[:, None] & (ki == (n_km - 1)[:, None]),
                      2, 0)
            + jnp.where(edge_r[:, None] & (ki == 0), 2, 0))
    ranks = jnp.where(ki < n_km[:, None], ranks - corr, 0)
    ranks = ranks.astype(jnp.int16 if use_i16 else jnp.int32)
    ranks = ranks.reshape(n_rows, PAD)

    def seg2(x):
        return x.reshape(n_rows, SEGS)

    rt = read_tab[read_id]
    return (ranks, seg2(n_km), seg2(ev_start), seg2(stride),
            seg2(n_ev), seg2(rt[:, RT_SCALE]), seg2(rt[:, RT_SHIFT]),
            seg2(rt[:, RT_VAR]), seg2(rt[:, RT_LP_STAY]),
            seg2(rt[:, RT_LP_STEP]))


@functools.partial(jax.jit,
                   static_argnames=("SEG", "k", "use_i16", "pad_events"))
def hmm_forward_meta(meta, packed_ref, read_tab, ev_pool,
                     level_mean, level_stdv, level_log_stdv,
                     SEG: int, k: int, use_i16: bool, pad_events: int):
    """Device-side input assembly + the XLA forward scorer.

    meta: (N_alloc, 16) u8 (pack_meta), N_alloc a multiple of 128//SEG;
    packed_ref: 2-bit codes of the disambiguated reference concat
    (>= 1 trailing zero sentinel); read_tab: (n_reads_pad, 8) f32;
    pad_events: the scan length (>= every window's event count).
    Returns scores f32 (n_rows, SEGS).
    """
    from .hmm import hmm_forward_packed, hmm_forward_packed4

    args = build_inputs(meta, packed_ref, read_tab, SEG=SEG, k=k,
                        use_i16=use_i16)
    tables = (level_mean, level_stdv, level_log_stdv)
    if SEG == 32:
        ranks, n_km, *rest = args
        return hmm_forward_packed4(ranks, n_km, ev_pool, *rest, *tables,
                                   pad_events=pad_events)
    if SEG != PAD:
        raise ValueError(f"SEG must be 32 or {PAD}, got {SEG}")
    ranks, *per_window = args
    cols = [x.reshape(-1) for x in per_window]
    s = hmm_forward_packed(ranks, cols[0], ev_pool, *cols[1:], *tables,
                           pad_events=pad_events)
    return s.reshape(-1, 1)
