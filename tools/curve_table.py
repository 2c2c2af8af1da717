#!/usr/bin/env python3
"""Render the curve-reproduction summary table from results/*.jsonl.

Reads every recorded sweep config known to tools/reproduce_curves.py,
recomputes the published-table z-scores with the same comparator the
reproduction runs use, and prints a Markdown table (for README.md) plus a
one-line status per config: grid coverage, sample scale vs the reference
tiers, worst |z|, and aggregate throughput.

Usage:
  python tools/curve_table.py [--markdown]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tools.reproduce_curves import (  # noqa: E402
    CONFIGS, GOLD, RESULTS, Z_THRESHOLD, _rate, aggregate_bits_per_s,
    compare)
from convolutional_codes.sim.sweep import (  # noqa: E402
    PointRecord, awgn_tier_bits, bsc_tier_bits)
from convolutional_codes.utils.records import read_jsonl  # noqa: E402


def load(name):
    path = RESULTS / f"{name}.jsonl"
    if not path.exists():
        return None
    return read_jsonl(path, PointRecord)


def scale_of(records, channel):
    """Fraction of the reference tier sample sizes actually simulated
    (min over points — the weakest point bounds the claim)."""
    tier = awgn_tier_bits if channel == "awgn" else bsc_tier_bits
    fracs = [r.bits / tier(r.point) for r in records]
    return min(fracs) if fracs else 0.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args()

    rows = []
    for name, (kw, row, channel) in CONFIGS.items():
        records = load(name)
        if not records:
            rows.append((name, channel, 0, 0.0, None, None))
            continue
        grid = GOLD[channel]["SNR" if channel == "awgn" else "ber_uncoded"]
        if row is None:
            # extension config: no published row to z-compare against
            worst = float("nan")
        else:
            _, worst = compare(records, channel, row)
        agg = _rate(aggregate_bits_per_s(records))
        rows.append((name, channel, f"{len(records)}/{len(grid)}",
                     scale_of(records, channel), worst, agg))

    if args.markdown:
        print("| config | grid | scale vs ref tiers | worst \\|z\\| | bits/s |")
        print("|---|---|---|---|---|")
        for name, channel, grid, scale, worst, agg in rows:
            if worst is None:
                print(f"| {name} | — | — | — | — |")
            else:
                print(f"| {name} | {grid} | {scale:.2g} | {worst:.2f} "
                      f"| {agg} |")
        return

    import math

    for name, channel, grid, scale, worst, agg in rows:
        if worst is None:
            print(f"{'MISS':4} {name:26s}")
        else:
            if math.isnan(worst):
                # extension config: no published row (anchored by the
                # closed-form / cliff artifact tests instead)
                flag = "EXT "
            else:
                flag = "OK " if worst < Z_THRESHOLD and scale >= 0.99 else (
                    "PART" if worst < Z_THRESHOLD else "WARN")
            print(f"{flag:4} {name:26s} grid={grid:6} scale={scale:8.2g} "
                  f"worst|z|={worst:6.2f} {agg}")


if __name__ == "__main__":
    main()
