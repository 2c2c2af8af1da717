"""Kernel checks that need the card (``gpu`` marker; skipped elsewhere).

Run them on an NVIDIA GPU in one process:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py -q

The CPU suite proves the same equalities in interpret mode (the Viterbi
kernel) and with the host build of native/seq_decode.cu; these runs prove
them for the code the GPU compilers produce — Triton's and nvcc's float
pipelines (FMA contraction, libdevice transcendentals) must reproduce the
XLA references bit for bit.  chip_smoke.py repeats them at production
widths.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.channels import awgn_sigma

pytestmark = pytest.mark.gpu


def _viterbi_ber(channel, param, code_key=0, demapper="soft", B=65536,
                 nsteps=4):
    from convolutional_codes.ops.viterbi_mc import mc_chain_viterbi

    code = get_code(code_key)
    be, fe = mc_chain_viterbi(code, B, nsteps, 11, param, channel,
                              demapper=demapper)
    bits = B * nsteps * code.block_length
    return int(be.sum()) / bits, bits


def _binomial_ok(ber, bits, expected, cluster=8.0, z=5.0):
    sigma = np.sqrt(cluster * expected * (1 - expected) / bits)
    return abs(ber - expected) <= z * sigma + cluster / bits


@pytest.mark.parametrize("channel,param,code_key,demapper,published", [
    ("awgn", float(awgn_sigma(8.0)), 0, "soft", 1.3756e-4),
    ("awgn", float(awgn_sigma(8.0)), 0, "hard", 2.23931e-3),
    ("bsc", 0.0125, 0, "soft", 9.545e-3),
    ("awgn", float(awgn_sigma(6.0)), 3, "soft", 2.478e-4),   # compat quirk
])
def test_viterbi_kernel_published_ber(channel, param, code_key, demapper,
                                      published):
    ber, bits = _viterbi_ber(channel, param, code_key, demapper)
    assert _binomial_ok(ber, bits, published), ber


def test_viterbi_kernel_noiseless_is_exact():
    assert _viterbi_ber("awgn", 0.0, B=4096, nsteps=1)[0] == 0.0
    assert _viterbi_ber("bsc", 0.0, B=4096, nsteps=1)[0] == 0.0


@pytest.mark.parametrize("ck,channel,demapper", [
    (0, "awgn", "soft"), (0, "bsc", "soft"), (5, "awgn", "hard"),
    ("nasa-k7", "awgn", "soft")])
def test_viterbi_kernel_counters_equal_replica(ck, channel, demapper):
    from convolutional_codes.ops.viterbi_mc import (
        mc_chain_viterbi, replica_counts)

    code = get_code(ck)
    param = 0.05 if channel == "bsc" else float(awgn_sigma(3.0))
    be, fe = mc_chain_viterbi(code, 16384, 2, 7, param, channel,
                              demapper=demapper)
    rb, rf = replica_counts(code, 16384, 2, 7, param, channel, demapper)
    assert np.array_equal(np.asarray(be), rb)
    assert np.array_equal(np.asarray(fe), rf)


@pytest.mark.parametrize("ck,channel,param", [
    ("k3-75", "bsc", 0.02), ("nasa-k7", "awgn", float(awgn_sigma(3.0)))])
def test_window_kernel_equals_replica(ck, channel, param):
    from convolutional_codes.ops.viterbi_mc import (
        longframe_replica_counts, mc_longframe_viterbi)

    code = get_code(ck)
    be, _ = mc_longframe_viterbi(code, 1024, 2, 5, param, channel)
    ref = longframe_replica_counts(code, 1024, 2, 5, param, channel)
    assert np.array_equal(np.asarray(be), ref)


SEQ_CASES = [
    # (decoder, code, channel, param, demapper, Fano timeout per bit).
    # Short Fano timeouts make timed-out frames (and so errors) certain and
    # keep the lockstep reference, which pays for its slowest frame, short.
    ("fano", 0, "awgn", float(awgn_sigma(4.0)), "soft", 40),
    ("fano", 4, "awgn", float(awgn_sigma(5.0)), "soft", 25),  # WSPR K=32
    ("fano", 0, "awgn", float(awgn_sigma(4.0)), "hard", 40),
    ("fano", 0, "bsc", 0.05, "soft", 60),
    ("fano", "k15-r14-16qam", "awgn", float(awgn_sigma(5.0)), "soft", 50),
    ("stack", 0, "awgn", float(awgn_sigma(5.0)), "soft", None),
    ("stack", 4, "awgn", float(awgn_sigma(4.0)), "soft", None),
    ("stack", 0, "bsc", 0.05, "soft", None),
]


@pytest.mark.parametrize("decoder,ck,channel,param,demapper,tpb", SEQ_CASES)
def test_sequential_kernel_equals_xla_machine(decoder, ck, channel, param,
                                              demapper, tpb):
    from convolutional_codes.ops import fano, stack
    from convolutional_codes.ops.mc_datagen import frames_host
    from convolutional_codes.ops.sequential_mc import (
        mc_sequential, sequential_decode)

    code = get_code(ck)
    lanes, fpl = 256, 2
    bits, syms = frames_host(code, np.arange(lanes * fpl), 17, param,
                             channel, demapper)
    kind = "soft" if channel == "awgn" else "hard"
    if decoder == "fano":
        ref_fn = getattr(fano, f"fano_decode_{kind}")
        ref = np.asarray(ref_fn(code, jnp.asarray(syms), tpb))
        kw = {"timeout_per_bit": tpb}
    else:
        ref = np.asarray(getattr(stack, f"stack_decode_{kind}")(
            code, jnp.asarray(syms)))
        kw = {}
    got = np.asarray(sequential_decode(decoder, code, jnp.asarray(syms),
                                       **kw))
    assert np.array_equal(got, ref)
    err = ref != bits[:, :code.block_length]
    be, fe, _ = mc_sequential(decoder, code, lanes, fpl, 17, param, channel,
                              demapper, **kw)
    assert (be, fe) == (int(err.sum()), int(err.any(1).sum()))
    assert be > 0


def test_fano_fma_regression_on_card():
    from conftest import load_golden
    from convolutional_codes.ops.sequential_mc import sequential_decode

    g = load_golden("fano_fma_regression.npz")
    out = np.asarray(sequential_decode("fano", get_code(0),
                                       jnp.asarray(g["dists"])))
    assert np.array_equal(out, g["decoded"])
