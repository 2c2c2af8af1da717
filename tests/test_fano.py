"""Batched Fano decoder vs pinned C-reference goldens (exact, per-bit)."""

import numpy as np
import pytest

from conftest import load_golden
from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.encoder import encode
from convolutional_codes.ops.fano import fano_decode_soft, fano_decode_hard

ALL_CODES = [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("idx", ALL_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_soft_matches_reference(idx, mode):
    g = load_golden(f"fano_soft_{idx}_m{mode}.npz")
    code = get_code(idx)
    out = np.asarray(fano_decode_soft(code, g["dists"]))
    assert np.array_equal(out, g["decoded"])


@pytest.mark.parametrize("idx", ALL_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_hard_matches_reference(idx, mode):
    g = load_golden(f"fano_hard_{idx}_m{mode}.npz")
    code = get_code(idx)
    out = np.asarray(fano_decode_hard(code, g["received"]))
    assert np.array_equal(out, g["decoded"])


@pytest.mark.parametrize("idx", [0, 4, "k15-r12"])
def test_noiseless_roundtrip(idx):
    code = get_code(idx)
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=(8, code.block_length))
    syms = np.asarray(encode(code, bits))
    dec = fano_decode_hard(code, syms)
    assert np.array_equal(np.asarray(dec), bits)
    M = code.points_per_symbol
    dists = np.ones(syms.shape + (M,), np.float32)
    np.put_along_axis(dists, syms[..., None], 0.0, axis=-1)
    dec2 = fano_decode_soft(code, dists)
    assert np.array_equal(np.asarray(dec2), bits)


def test_diagnostics_report_timeouts_and_metric():
    from convolutional_codes.ops.fano import fano_decode_soft_with_diag

    code = get_code(0)
    rng = np.random.default_rng(4)
    M, T = code.points_per_symbol, code.num_block_symbols
    # random garbage distances: most frames should burn the budget
    dists = rng.random((4, T, M)).astype(np.float32) * 8.0
    bits, diag = fano_decode_soft_with_diag(code, dists, 50)
    assert diag["timeout_left"].shape == (4,)
    assert bool(np.asarray(diag["timed_out"]).any())
    # noiseless: no timeout, full depth would have emitted at T
    syms = np.asarray(encode(code, rng.integers(0, 2, size=(4, code.block_length))))
    clean = np.ones(syms.shape + (M,), np.float32)
    np.put_along_axis(clean, syms[..., None], 0.0, axis=-1)
    bits2, diag2 = fano_decode_soft_with_diag(code, clean)
    assert not bool(np.asarray(diag2["timed_out"]).any())


def test_fma_rounding_regression():
    """A timeout-path frame where FMA-contracted branch metrics
    (fl(1 + w*d) instead of the spec's fl(1 + fl(w*d))) send the walk down
    a different trajectory.  Caught by the native-oracle deep fuzz; the
    decoders must round the product first (sequential_common.force_rounded).
    The pinned bits come from tests/golden_model.py, cross-checked with the
    native oracle."""
    g = load_golden("fano_fma_regression.npz")
    code = get_code(0)
    out = np.asarray(fano_decode_soft(code, g["dists"]))
    assert np.array_equal(out, g["decoded"])
