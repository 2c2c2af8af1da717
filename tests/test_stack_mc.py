"""Stack Monte-Carlo through the one-frame-per-thread kernel
(ops/sequential_mc, built for the CPU): exactness + determinism.

Error counts must equal ops/stack.stack_decode_soft/_hard on the identical
hash-generated frames (ops/mc_datagen.frames_host)."""

import numpy as np
import pytest

import jax.numpy as jnp

from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.channels import awgn_sigma
from convolutional_codes.ops.stack import stack_decode_soft, stack_decode_hard
from convolutional_codes.ops.mc_datagen import frames_host as stack_frames_host
from convolutional_codes.ops.sequential_mc import mc_stack

CASES = [
    # (code, channel, param, demapper, frames_per_lane)
    (0, "awgn", float(awgn_sigma(6.0)), "soft", 2),
    (0, "bsc", 0.05, "soft", 2),       # noisy: deep search + worst-replace
    (5, "awgn", float(awgn_sigma(4.0)), "soft", 2),  # rate 1/3, M=8
    # production-routed configs the sweep sends through mc_stack:
    (4, "awgn", float(awgn_sigma(4.0)), "soft", 1),  # WSPR K=32, quirk P1
    (0, "awgn", float(awgn_sigma(5.0)), "hard", 2),  # hard demapper
]


@pytest.mark.parametrize("ck,channel,param,dem,fpl", CASES)
def test_counts_match_xla_machine(ck, channel, param, dem, fpl):
    code = get_code(ck)
    lanes = 64
    be, fe, nb = mc_stack(code, lanes, fpl, 42, param, channel=channel,
                          demapper=dem)
    bits, syms = stack_frames_host(code, np.arange(lanes * fpl), 42, param,
                                   channel, dem)
    if channel == "awgn":
        dec = stack_decode_soft(code, jnp.asarray(syms))
    else:
        dec = stack_decode_hard(code, jnp.asarray(syms))
    err = np.asarray(dec) != bits[:, : code.block_length]
    assert (be, fe) == (int(err.sum()), int(err.any(1).sum()))
    assert nb == lanes * fpl * code.block_length
    assert be > 0


def test_deterministic_and_seed_sensitive():
    code = get_code(0)
    kw = dict(channel="bsc")
    a = mc_stack(code, 64, 1, 7, 0.05, **kw)
    b = mc_stack(code, 64, 1, 7, 0.05, **kw)
    c = mc_stack(code, 64, 1, 8, 0.05, **kw)
    assert a == b
    assert a != c
