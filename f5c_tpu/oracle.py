"""The pure-NumPy oracle stack end to end, and the reference's tolerant
TSV comparison.

``oracle_read_state`` runs one read through ops/events_ref ->
ops/abea_ref (align + postalign + recalibrate); ``oracle_meth_rows``
adds pipeline/methylation.call_methylation_for_read (the ops/hmm_ref
forward scorer).  No device code.  They generate the vendored golden
fixtures (scripts/make_golden_fixtures.py) and check the device pipeline
at real size (chip_smoke.py).

``tolerant_compare`` is the reference's awk oracle (scripts/test.awk:
7-13): string columns equal, float columns within |x - t| <= 0.1|t| +
0.02, at most ``max_deviant`` of the rows deviating.
"""

from __future__ import annotations

import numpy as np


def oracle_read_state(pa: np.ndarray, read_seq: str, model):
    """events -> MoM -> ABEA (vs the read) -> postalign + recalibrate,
    all through ops/*_ref.py.  Returns None when any QC rejects."""
    from .ops.abea_ref import (align, estimate_scalings_using_mom,
                               postalign, recalibrate_model)
    from .ops.events_ref import detect_events

    et = detect_events(pa)
    sc = estimate_scalings_using_mom(read_seq, model, et.mean)
    res = align(read_seq, et.mean, model, sc)
    if res.failed:
        return None
    n_kmers = len(read_seq) - model.k + 1
    post = postalign(res.pairs, read_seq, n_kmers, model)
    ok, rc = recalibrate_model(model, et.mean, post, read_seq)
    if not ok or rc.var > 2.5 or post.events_per_base > 5.0:
        return None
    return dict(events=et, scaling=rc,
                b2e_start=post.base_to_event_start,
                b2e_stop=post.base_to_event_stop,
                events_per_base=post.events_per_base)


def oracle_meth_rows(contig: str, ref_seq: str, qname: str, read_seq: str,
                     pos: int, cigar, is_reverse: bool, state, cpg_model,
                     out_version: int) -> str:
    """One read's call-methylation TSV rows through the oracle HMM;
    ``ref_seq`` is the reference from ``pos`` over the read's span."""
    from .pipeline.methylation import call_methylation_for_read
    from .pipeline.runner import _render_meth_rows

    site_map = call_methylation_for_read(
        ref_seq, pos, cigar, is_reverse, len(read_seq),
        state["events"].mean.astype(np.float32), state["b2e_start"],
        state["scaling"], cpg_model, state["events_per_base"])
    rows = _render_meth_rows(contig, qname, is_reverse, site_map,
                             out_version, -1, -1)
    return rows.decode() if isinstance(rows, bytes) else rows


def tolerant_compare(ours: str, truth: str, float_cols: set,
                     max_deviant: float = 0.0, header: bool = True):
    """Row-by-row comparison of two TSV texts; returns (n_deviant,
    n_rows) and raises AssertionError when the row counts differ or
    more than ``max_deviant`` of the rows deviate."""
    a_rows = ours.rstrip("\n").split("\n")
    b_rows = truth.rstrip("\n").split("\n")
    assert len(a_rows) == len(b_rows), (
        f"row count {len(a_rows)} != {len(b_rows)}")
    skip = 1 if header else 0
    bad = []
    for rn, (la, lb) in enumerate(zip(a_rows[skip:], b_rows[skip:])):
        a, b = la.split("\t"), lb.split("\t")
        ok = len(a) == len(b)
        if ok:
            for i, (x, y) in enumerate(zip(a, b)):
                if i in float_cols:
                    if abs(float(x) - float(y)) > 0.1 * abs(float(y)) + 0.02:
                        ok = False
                        break
                elif x != y:
                    ok = False
                    break
        if not ok:
            bad.append((rn, la, lb))
    n = max(len(a_rows) - skip, 1)
    assert len(bad) / n <= max_deviant, (
        f"{len(bad)}/{n} rows deviate; first: {bad[0]}")
    return len(bad), n
