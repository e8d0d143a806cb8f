#!/usr/bin/env python3
"""Join two per-site methylation frequency tables and report agreement.

This repo's equivalent of the reference's nanopolish-quickstart helpers
(scripts/compare_methylation.py + plot_methylation.R): reads two
`meth-freq` TSVs (or bedMethyl files, e.g. bisulfite truth), joins them
on (chromosome, start, end), prints a comparison TSV

    key  frequency_1  frequency_2  called_sites_1  called_sites_2

to stdout plus N / Pearson r to stderr, and with --plot renders the
2D-histogram correlation figure (matplotlib stand-in for the R script).

Usage:
  python scripts/compare_methylation.py a.freq.tsv b.freq.tsv \
      [--min-reads 5] [--plot out.png]
"""

from __future__ import annotations

import argparse
import csv
import math
import sys


def load_methfreq(path):
    """f5c/nanopolish meth-freq TSV -> {(chrom,start,end): (reads, meth)}.
    Non-singleton CpG groups are skipped, matching the reference
    comparator (grouped sites have no single genomic coordinate to join
    a truth set on)."""
    out = {}
    with open(path) as fh:
        rd = csv.DictReader(fh, delimiter="\t")
        group_col = ("num_motifs_in_group"
                     if "num_motifs_in_group" in (rd.fieldnames or [])
                     else "num_cpgs_in_group")
        for rec in rd:
            if int(rec[group_col]) > 1:
                continue
            key = (rec["chromosome"], int(rec["start"]), int(rec["end"]))
            reads = int(rec["called_sites"])
            meth = int(rec["called_sites_methylated"])
            r0, m0 = out.get(key, (0, 0))
            out[key] = (r0 + reads, m0 + meth)
    return out


def load_bedmethyl(path):
    """bedMethyl (e.g. bisulfite truth) -> same dict; reverse-strand
    records accumulate onto the forward-strand CpG coordinate."""
    out = {}
    with open(path) as fh:
        for line in fh:
            f = line.split()
            if len(f) < 11:
                continue
            chrom, start, strand = f[0], int(f[1]), f[5]
            reads = float(f[9])
            meth = int(float(f[10]) / 100.0 * reads)
            pos = start if strand == "+" else start - 1
            key = (chrom, pos, pos)
            r0, m0 = out.get(key, (0, 0))
            out[key] = (r0 + int(reads), m0 + meth)
    return out


def load(path):
    with open(path) as fh:
        first = fh.readline()
    if first.startswith("chromosome"):
        return load_methfreq(path)
    return load_bedmethyl(path)


def pearson(xs, ys):
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    num = sum((x - mx) * (y - my) for x, y in zip(xs, ys))
    dx = math.sqrt(sum((x - mx) ** 2 for x in xs))
    dy = math.sqrt(sum((y - my) ** 2 for y in ys))
    return num / (dx * dy) if dx and dy else float("nan")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("freq1", help="meth-freq TSV or bedMethyl")
    ap.add_argument("freq2", help="meth-freq TSV or bedMethyl")
    ap.add_argument("--min-reads", type=int, default=1,
                    help="require >= this many called reads in BOTH "
                         "files [1]")
    ap.add_argument("--plot", default=None, metavar="FILE",
                    help="write a 2D-histogram correlation figure "
                         "(png/pdf by extension)")
    args = ap.parse_args()

    a = load(args.freq1)
    b = load(args.freq2)
    xs, ys = [], []
    w = csv.writer(sys.stdout, delimiter="\t", lineterminator="\n")
    w.writerow(["key", "frequency_1", "frequency_2",
                "called_sites_1", "called_sites_2"])
    for key in sorted(set(a) & set(b)):
        r1, m1 = a[key]
        r2, m2 = b[key]
        if r1 < args.min_reads or r2 < args.min_reads:
            continue
        f1, f2 = m1 / r1, m2 / r2
        xs.append(f1)
        ys.append(f2)
        w.writerow([f"{key[0]}:{key[1]}-{key[2]}",
                    f"{f1:.3f}", f"{f2:.3f}", r1, r2])
    if not xs:
        print("no overlapping sites", file=sys.stderr)
        return 1
    r = pearson(xs, ys)
    print(f"N = {len(xs)} r = {r:.10f}", file=sys.stderr)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.colors import LogNorm

        fig, ax = plt.subplots(figsize=(10, 8))
        h = ax.hist2d(xs, ys, bins=25, range=[[0, 1], [0, 1]],
                      norm=LogNorm(), cmap="Spectral_r")
        fig.colorbar(h[3], ax=ax, label="sites")
        ax.set_xlabel(f"Methylation frequency: {args.freq1}")
        ax.set_ylabel(f"Methylation frequency: {args.freq2}")
        ax.set_title(f"N = {len(xs)} r = {r:.4f}")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
