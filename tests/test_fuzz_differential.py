"""Differential fuzz: random user-registered codes, batch decoders vs the
golden scalar model.

The pinned goldens (tests/goldens/) cover the six shipped codes; user codes
register at runtime (Readme.md:19 promises extensibility), so this pins the
generic table-driven paths on randomly drawn codes — random K, rate,
polynomials, parity mode, decoder tunings — against `tests/golden_model.py`
(the executable spec validated bit-for-bit against the C reference).
Channels are exercised by decoding *noisy* symbol streams: random symbol
corruption for the hard decoders, perturbed distance vectors for the soft
ones, so tie-breaking and backtracking paths actually fire.
"""

import numpy as np
import pytest

import tests.golden_model as gm
from convolutional_codes.models.codebook import Code
from convolutional_codes.ops.encoder import encode
from convolutional_codes.ops.fano import fano_decode_hard, fano_decode_soft
from convolutional_codes.ops.stack import stack_decode_hard, stack_decode_soft
from convolutional_codes.ops.viterbi import (
    viterbi_decode_hard, viterbi_decode_soft)

import jax.numpy as jnp


def _random_code(rng: np.random.Generator, idx: int) -> Code:
    K = int(rng.integers(3, 7))
    symlen = int(rng.integers(2, 4))
    # top bit set so the newest input always taps in (non-degenerate);
    # ensure no all-zero polynomial
    polys = tuple(int(rng.integers(1, 1 << K)) | (1 << (K - 1))
                  for _ in range(symlen))
    wrong = -int(rng.integers(5, 60))
    return Code(name=f"fuzz-{idx}", symlen_out=symlen, constraint_length=K,
                block_length=int(rng.integers(8, 24)),
                polynomials=polys,
                bit_metrics=(1, wrong), fano_bit_metrics=(1, wrong - 5),
                metric_weight=-float(rng.integers(5, 25)),
                fano_metric_weight=-float(rng.integers(40, 220)),
                parity=("compat" if rng.integers(2) else "true"))


def _noisy_streams(code: Code, rng: np.random.Generator, frames: int):
    """(bits, corrupted hard symbols, perturbed soft distance vectors)."""
    T = code.num_block_symbols
    M = code.points_per_symbol
    bits = rng.integers(0, 2, (frames, code.block_length)).astype(np.int32)
    syms = np.asarray(encode(code, jnp.asarray(bits)))
    flips = (rng.random((frames, T, code.symlen_out)) < 0.06)
    fl = (flips << np.arange(code.symlen_out)).sum(-1).astype(np.int32)
    hard_rx = syms ^ fl
    # soft: distance vector of the flipped symbol plus small jitter — keeps
    # metric ordering data-dependent without ties at float resolution
    dists = np.array([[bin(e ^ s).count("1") for e in range(M)]
                      for s in range(M)], np.float32)[hard_rx]
    dists = dists + rng.random(dists.shape).astype(np.float32) * 0.25
    return bits, hard_rx, dists


@pytest.mark.parametrize("seed", [11, 22, 33, 44])
def test_random_code_decoders_match_golden_model(seed):
    rng = np.random.default_rng(seed)
    code = _random_code(rng, seed)
    frames = 6
    bits, hard_rx, dists = _noisy_streams(code, rng, frames)

    v_s = np.asarray(viterbi_decode_soft(code, jnp.asarray(dists)))
    v_h, v_pm = (np.asarray(x) for x in
                 viterbi_decode_hard(code, jnp.asarray(hard_rx)))
    s_s = np.asarray(stack_decode_soft(code, jnp.asarray(dists)))
    s_h = np.asarray(stack_decode_hard(code, jnp.asarray(hard_rx)))
    f_s = np.asarray(fano_decode_soft(code, jnp.asarray(dists)))
    f_h = np.asarray(fano_decode_hard(code, jnp.asarray(hard_rx)))

    for i in range(frames):
        assert np.array_equal(v_s[i], gm.viterbi_soft(code, dists[i])), \
            ("viterbi_soft", i, code)
        gh, gpm = gm.viterbi_hard(code, hard_rx[i])
        assert np.array_equal(v_h[i], gh), ("viterbi_hard", i, code)
        assert int(v_pm[i]) == int(gpm), ("viterbi_hard_metric", i, code)
        assert np.array_equal(s_s[i], gm.stack_soft(code, dists[i])), \
            ("stack_soft", i, code)
        assert np.array_equal(s_h[i], gm.stack_hard(code, hard_rx[i])), \
            ("stack_hard", i, code)
        assert np.array_equal(f_s[i], gm.fano_soft(code, dists[i])), \
            ("fano_soft", i, code)
        assert np.array_equal(f_h[i], gm.fano_hard(code, hard_rx[i])), \
            ("fano_hard", i, code)


@pytest.mark.parametrize("seed", [55, 66])
def test_random_bigK_sequential_matches_golden_model(seed):
    """WSPR-class constraint lengths (K ~ 30, random polynomials): the
    sequential decoders carry the encoder state in wide integers (the
    reference uses uint64, stack-decoder.c:249-272); only the shipped
    K=32 WSPR code pins that path in the goldens, so fuzz it too.
    Viterbi is excluded (2^(K-1) states is not a decoder at this K)."""
    rng = np.random.default_rng(seed)
    K = int(rng.integers(28, 33))   # registry caps K at 32 (int32 lanes)
    polys = tuple(int(rng.integers(1, 1 << K)) | (1 << (K - 1))
                  for _ in range(2))
    wrong = -int(rng.integers(20, 50))
    code = Code(name=f"fuzz-big-{seed}", symlen_out=2, constraint_length=K,
                block_length=int(rng.integers(12, 20)), polynomials=polys,
                bit_metrics=(1, wrong), fano_bit_metrics=(1, wrong - 8),
                metric_weight=-9.0, fano_metric_weight=-13.0,
                parity=("compat" if rng.integers(2) else "true"))
    frames = 4
    bits, hard_rx, dists = _noisy_streams(code, rng, frames)

    s_s = np.asarray(stack_decode_soft(code, jnp.asarray(dists)))
    s_h = np.asarray(stack_decode_hard(code, jnp.asarray(hard_rx)))
    f_s = np.asarray(fano_decode_soft(code, jnp.asarray(dists)))
    f_h = np.asarray(fano_decode_hard(code, jnp.asarray(hard_rx)))
    for i in range(frames):
        assert np.array_equal(s_s[i], gm.stack_soft(code, dists[i])), \
            ("stack_soft", i, code)
        assert np.array_equal(s_h[i], gm.stack_hard(code, hard_rx[i])), \
            ("stack_hard", i, code)
        assert np.array_equal(f_s[i], gm.fano_soft(code, dists[i])), \
            ("fano_soft", i, code)
        assert np.array_equal(f_h[i], gm.fano_hard(code, hard_rx[i])), \
            ("fano_hard", i, code)


def test_random_code_pallas_kernels_match_golden_model():
    """One random runtime-registered code through the one-frame-per-thread
    sequential kernel (native/seq_decode.cu, built for the CPU) — its walks
    must be as code-agnostic as the XLA formulations the other fuzz cases
    pin."""
    from convolutional_codes.ops.sequential_mc import sequential_decode

    rng = np.random.default_rng(77)
    code = _random_code(rng, 77)
    frames = 4
    bits, hard_rx, dists = _noisy_streams(code, rng, frames)

    s_s = np.asarray(sequential_decode("stack", code, jnp.asarray(dists)))
    f_h = np.asarray(sequential_decode("fano", code, jnp.asarray(hard_rx)))
    for i in range(frames):
        assert np.array_equal(s_s[i], gm.stack_soft(code, dists[i])), i
        assert np.array_equal(f_h[i], gm.fano_hard(code, hard_rx[i])), i
