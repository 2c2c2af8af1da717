"""Fano Monte-Carlo through the one-frame-per-thread kernel
(ops/sequential_mc, native/seq_decode.cu built for the CPU): exactness +
determinism.

Error counts must equal ops/fano.fano_decode_soft/_hard run on the
identical frames (rebuilt host-side via the same coordinate-hash stages,
ops/mc_datagen.frames_host).  The timeout-rich case exercises the full
walk: search, backtrack, threshold relax/tighten, timeout exhaustion, the
ignore latch, and a thread moving on to its next frame.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.channels import awgn_sigma
from convolutional_codes.ops.fano import fano_decode_soft, fano_decode_hard
from convolutional_codes.ops.mc_datagen import frames_host as fano_frames_host
from convolutional_codes.ops.sequential_mc import mc_fano

CASES = [
    # (code, channel, param, demapper, timeout_per_bit, frames_per_lane)
    (0, "awgn", float(awgn_sigma(2.0)), "soft", 40, 2),  # timeout-rich
    (0, "bsc", 0.05, "soft", 60, 2),                     # hard metrics
    (5, "awgn", float(awgn_sigma(3.0)), "soft", 50, 2),  # rate 1/3, M=8
    # production-routed configs the sweep sends through mc_fano:
    (4, "awgn", float(awgn_sigma(5.0)), "soft", 25, 1),  # WSPR K=32, quirk P1
    (4, "bsc", 0.02, "soft", 30, 1),                     # WSPR hard metrics
    (0, "awgn", float(awgn_sigma(4.0)), "hard", 40, 2),  # hard demapper
]


@pytest.mark.parametrize("ck,channel,param,dem,tpb,fpl", CASES)
def test_counts_match_xla_machine(ck, channel, param, dem, tpb, fpl):
    code = get_code(ck)
    lanes = 64
    be, fe, nb = mc_fano(code, lanes, fpl, 42, param, channel=channel,
                         demapper=dem, timeout_per_bit=tpb)
    bits, syms = fano_frames_host(code, np.arange(lanes * fpl), 42, param,
                                  channel, dem)
    if channel == "awgn":
        dec = fano_decode_soft(code, jnp.asarray(syms), tpb)
    else:
        dec = fano_decode_hard(code, jnp.asarray(syms), tpb)
    err = np.asarray(dec) != bits[:, : code.block_length]
    assert (be, fe) == (int(err.sum()), int(err.any(1).sum()))
    assert nb == lanes * fpl * code.block_length
    assert be > 0  # the case must actually exercise errors


def test_16qam_counts_match_xla_machine():
    """K=15 + 16-QAM (T*M = 3424): the largest frame any production
    config puts in the kernel.  Cliff-region noise so real errors flow."""
    code = get_code("k15-r14-16qam")
    param = float(awgn_sigma(5.0))
    be, fe, nb = mc_fano(code, 16, 1, 42, param, channel="awgn",
                         demapper="soft", timeout_per_bit=50)
    bits, syms = fano_frames_host(code, np.arange(16), 42, param,
                                  "awgn", "soft")
    dec = fano_decode_soft(code, jnp.asarray(syms), 50)
    err = np.asarray(dec) != bits[:, : code.block_length]
    assert (be, fe) == (int(err.sum()), int(err.any(1).sum()))
    assert be > 0


def test_deterministic_and_seed_sensitive():
    code = get_code(0)
    kw = dict(channel="awgn", timeout_per_bit=30)
    param = float(awgn_sigma(4.0))
    a = mc_fano(code, 64, 1, 7, param, **kw)
    b = mc_fano(code, 64, 1, 7, param, **kw)
    c = mc_fano(code, 64, 1, 8, param, **kw)
    assert a == b
    assert a != c
