"""Batched Viterbi vs pinned C-reference goldens (exact, per-bit)."""

import numpy as np
import pytest

from conftest import load_golden
from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.encoder import encode
from convolutional_codes.ops.viterbi import (
    viterbi_decode_soft, viterbi_decode_hard, hard_branch_metrics)

VITERBI_CODES = [0, 1, 2, 3, 5]


@pytest.mark.parametrize("idx", VITERBI_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_soft_matches_reference(idx, mode):
    g = load_golden(f"viterbi_soft_{idx}_m{mode}.npz")
    code = get_code(idx)
    out = np.asarray(viterbi_decode_soft(code, g["dists"]))
    assert np.array_equal(out, g["decoded"])


@pytest.mark.parametrize("idx", VITERBI_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_hard_matches_reference(idx, mode):
    g = load_golden(f"viterbi_hard_{idx}_m{mode}.npz")
    code = get_code(idx)
    bits, metric = viterbi_decode_hard(code, g["received"])
    assert np.array_equal(np.asarray(bits), g["decoded"])
    assert np.array_equal(np.asarray(metric), g["metrics"])


@pytest.mark.parametrize("idx", VITERBI_CODES + ["nasa-k7", "k9-r12"])
def test_noiseless_roundtrip(idx):
    """On a clean channel Viterbi must reproduce the input exactly."""
    code = get_code(idx)
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, size=(32, code.block_length))
    syms = encode(code, bits)
    # hard: received symbols are exactly the encoded ones
    dec, metric = viterbi_decode_hard(code, syms)
    assert np.array_equal(np.asarray(dec), bits)
    assert np.all(np.asarray(metric) == 0)
    # soft: one-hot distance vectors (0 for tx symbol, 1 elsewhere)
    M = code.points_per_symbol
    dists = np.ones(syms.shape + (M,), np.float32)
    np.put_along_axis(dists, np.asarray(syms)[..., None], 0.0, axis=-1)
    dec2 = viterbi_decode_soft(code, dists)
    assert np.array_equal(np.asarray(dec2), bits)


def test_hard_branch_metrics_are_hamming():
    code = get_code(0)
    rx = np.array([[0, 1, 2, 3]])
    bm = np.asarray(hard_branch_metrics(code, rx))
    expect = np.array([[bin(r ^ e).count("1") for e in range(4)] for r in rx[0]])
    assert np.array_equal(bm[0], expect)
