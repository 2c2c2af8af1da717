"""Fused Viterbi Monte-Carlo kernel (ops/viterbi_mc, Pallas through Triton)
in interpret mode: its per-lane counters must equal its XLA replica — the
same coordinate-hash frames rebuilt by ops/mc_datagen and decoded by the
XLA ``viterbi_decode_*`` (ops/viterbi_mc.replica_counts).  The compiled
kernel is held to the same equality on the card (tests/test_gpu.py)."""

import numpy as np
import pytest

from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.channels import awgn_sigma
from convolutional_codes.ops.viterbi_mc import (
    eligible, mc_chain_viterbi, replica_counts)

SIGMA = float(awgn_sigma(2.0))

CASES = [
    # (code, channel, demapper, param): every kernel-eligible reference
    # code, the (7,5) code and NASA K=7 (two decision words per step)
    (0, "awgn", "soft", SIGMA),
    (0, "awgn", "hard", SIGMA),
    (0, "bsc", "soft", 0.06),
    (1, "awgn", "soft", SIGMA),
    (1, "bsc", "soft", 0.06),
    (2, "awgn", "hard", SIGMA),
    (3, "awgn", "soft", SIGMA),
    (3, "bsc", "soft", 0.06),
    (5, "awgn", "soft", SIGMA),
    (5, "awgn", "hard", SIGMA),
    ("k3-75", "bsc", "soft", 0.06),
    ("nasa-k7", "awgn", "soft", float(awgn_sigma(1.0))),
]


@pytest.mark.parametrize("ck,channel,demapper,param", CASES)
def test_counters_equal_xla_replica(ck, channel, demapper, param):
    code = get_code(ck)
    lanes, nsteps = 32, 2
    be, fe = mc_chain_viterbi(code, lanes, nsteps, 11, param,
                              channel=channel, demapper=demapper,
                              interpret=True)
    rb, rf = replica_counts(code, lanes, nsteps, 11, param, channel,
                            demapper)
    assert np.array_equal(np.asarray(be), rb)
    assert np.array_equal(np.asarray(fe), rf)
    assert rb.sum() > 0          # the case must exercise errors


def test_eligibility_and_tiling():
    assert eligible(get_code("nasa-k7"))
    assert not eligible(get_code("k9-r12"))          # 256 states
    assert not eligible(get_code("k15-r14-16qam"))
    with pytest.raises(ValueError, match="at most"):
        mc_chain_viterbi(get_code("k9-r12"), 32, 1, 0, 0.5, interpret=True)
    with pytest.raises(ValueError, match="power-of-two"):
        mc_chain_viterbi(get_code(0), 96, 1, 0, 0.5, interpret=True,
                         block_lanes=64)
