"""Encoder vs pinned C-reference goldens (exact) for all 6 codes."""

import numpy as np
import pytest

import golden_model as gm
from conftest import load_golden
from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.encoder import encode


@pytest.mark.parametrize("idx", range(6))
def test_encode_matches_reference(idx):
    g = load_golden(f"enc_{idx}.npz")
    code = get_code(idx)
    out = np.asarray(encode(code, g["bits"]))
    assert np.array_equal(out, g["symbols"])


@pytest.mark.parametrize("name", ["nasa-k7", "k9-r12", "k15-r12"])
def test_encode_extension_codes_vs_golden_model(name):
    code = get_code(name)
    rng = np.random.default_rng(42)
    bits = rng.integers(0, 2, size=(8, code.block_length))
    out = np.asarray(encode(code, bits))
    model = np.stack([gm.encode_block(code, b) for b in bits])
    assert np.array_equal(out, model)


def test_encode_true_parity_differs_for_quirky_code():
    code = get_code(1)  # compat by default, quirk on P0
    true_code = code.replace(parity="true")
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, size=(16, code.block_length))
    assert not np.array_equal(np.asarray(encode(code, bits)),
                              np.asarray(encode(true_code, bits)))
    model = np.stack([gm.encode_block(true_code, b) for b in bits])
    assert np.array_equal(np.asarray(encode(true_code, bits)), model)


def test_encode_zero_input_terminates_at_zero():
    code = get_code(0)
    out = np.asarray(encode(code, np.zeros((1, code.block_length), np.int32)))
    assert np.all(out == 0)
