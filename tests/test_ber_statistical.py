"""Statistical BER integration tests vs published reference points.

Each test simulates enough bits for a few-sigma binomial check against a
row of the published tables (tests/goldens/published_curves.json, extracted
from results/*.m — the reference's golden record, SURVEY.md §6).  The
published values carry their own Monte-Carlo noise (tier sample sizes), so
comparisons use combined-variance z-scores.
"""

import json
import math
import os

import numpy as np
import pytest

from convolutional_codes.sim.sweep import (
    SweepSpec, run_sweep, awgn_tier_bits, bsc_tier_bits)

GOLD = json.load(open(os.path.join(os.path.dirname(__file__), "goldens",
                                   "published_curves.json")))


def check(rec, channel, row, z_max=4.5):
    grid = GOLD[channel]["SNR" if channel == "awgn" else "ber_uncoded"]
    pub = GOLD[channel][row]
    idx = min(range(len(grid)), key=lambda j: abs(grid[j] - rec.point))
    p_pub = pub[idx]
    n_pub = (awgn_tier_bits if channel == "awgn" else bsc_tier_bits)(rec.point)
    # Bit errors cluster per frame (a lost frame contributes many errors at
    # once), so per-bit binomial variance underestimates spread: inflate by
    # the mean cluster size on both sides.
    if rec.bit_errors == 0 and p_pub > 0:
        # zero observations: significance is set by expected frame EVENTS
        frame_bits = rec.bits / max(rec.frames, 1)
        z = -math.sqrt(p_pub * rec.bits / max(1.0, frame_bits / 4))
    else:
        cluster = max(1.0, rec.bit_errors / max(rec.frame_errors, 1))
        var = cluster * ((rec.ber * (1 - rec.ber)) / rec.bits
                         + (p_pub * (1 - p_pub)) / n_pub)
        z = (rec.ber - p_pub) / math.sqrt(var) if var else 0.0
    assert abs(z) < z_max, (f"{row} point {rec.point}: ours {rec.ber:.4e} "
                            f"vs published {p_pub:.4e}, z={z:.1f}")


def _run(point, bits, **kw):
    spec = SweepSpec(points=[point], bits_per_point=bits,
                     frames_per_step=kw.pop("frames", 512), seed=99, **kw)
    (r,) = run_sweep(spec, verbose=False)
    return r


def test_stack_bsc_published_point():
    r = _run(0.05, 2e5, code=0, channel="bsc", decoder="stack")
    check(r, "bsc", "ber_coded_a_stack")


def test_stack_awgn_soft_published_point():
    r = _run(0.0, 1e5, code=0, channel="awgn", decoder="stack", frames=256)
    check(r, "awgn", "ber_coded_a_stack")


def test_viterbi_awgn_hard_demapper_published_point():
    """Hard-decision AWGN curves: snap-then-distance demapper feeding the
    soft decoder (hard-demapper.c drop-in semantics)."""
    r = _run(4.0, 4e5, code=0, channel="awgn", decoder="viterbi",
             demapper="hard", frames=2048)
    check(r, "awgn", "ber_coded_ah")


def test_fano_awgn_soft_published_point():
    # 4 dB keeps the timeout path rare so the lockstep loop stays fast
    r = _run(4.0, 4e4, code=0, channel="awgn", decoder="fano", frames=128)
    check(r, "awgn", "ber_coded_a_fano")


def test_fano_bsc_published_point():
    r = _run(0.05, 5e4, code=0, channel="bsc", decoder="fano", frames=128)
    check(r, "bsc", "ber_coded_a_fano")


def test_uncoded_8qam_published_point():
    r = _run(4.0, 3e5, code=5, channel="uncoded", frames=1 << 14)
    check(r, "awgn", "ber_uncoded_3")
