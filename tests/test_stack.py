"""Batched stack decoder vs pinned C-reference goldens (exact, per-bit)."""

import numpy as np
import pytest

from conftest import load_golden
from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.encoder import encode
from convolutional_codes.ops.stack import stack_decode_soft, stack_decode_hard

ALL_CODES = [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("idx", ALL_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_soft_matches_reference(idx, mode):
    g = load_golden(f"stack_soft_{idx}_m{mode}.npz")
    code = get_code(idx)
    out = np.asarray(stack_decode_soft(code, g["dists"]))
    assert np.array_equal(out, g["decoded"])


@pytest.mark.parametrize("idx", ALL_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_hard_matches_reference(idx, mode):
    g = load_golden(f"stack_hard_{idx}_m{mode}.npz")
    code = get_code(idx)
    out = np.asarray(stack_decode_hard(code, g["received"]))
    assert np.array_equal(out, g["decoded"])


@pytest.mark.parametrize("idx", [0, 4, "k9-r12"])
def test_noiseless_roundtrip(idx):
    code = get_code(idx)
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(8, code.block_length))
    syms = np.asarray(encode(code, bits))
    dec = stack_decode_hard(code, syms)
    assert np.array_equal(np.asarray(dec), bits)
    M = code.points_per_symbol
    dists = np.ones(syms.shape + (M,), np.float32)
    np.put_along_axis(dists, syms[..., None], 0.0, axis=-1)
    dec2 = stack_decode_soft(code, dists)
    assert np.array_equal(np.asarray(dec2), bits)


def test_hard_metric_matches_golden_model():
    """The winning path metric mirrors what the reference's BSC callback
    carries (binary-symmetric-channel/include/decoder.h:9)."""
    import golden_model as gm
    from convolutional_codes.ops.stack import stack_decode_hard_with_metric

    code = get_code(0)
    rng = np.random.default_rng(13)
    rx = rng.integers(0, 4, size=(16, code.num_block_symbols))
    bits, metric = stack_decode_hard_with_metric(code, rx)
    for b in range(rx.shape[0]):
        paths_bits = gm.stack_hard(code, rx[b])
        assert np.array_equal(np.asarray(bits)[b], paths_bits)
    # metric sanity: noiseless decode has metric == symlen*correct*T
    syms = np.asarray(encode(code, rng.integers(0, 2, size=(4, code.block_length))))
    _, m0 = stack_decode_hard_with_metric(code, syms)
    expect = code.num_block_symbols * code.symlen_out * code.bit_metrics[0]
    assert np.all(np.asarray(m0) == expect)
