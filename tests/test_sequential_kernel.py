"""The one-frame-per-thread stack/Fano kernel (native/seq_decode.cu, built
for the CPU) against the pinned C-reference goldens, bit for bit, and the
wrapper's input checks.  The GPU build of the same source is checked
against ops/stack.py and ops/fano.py in tests/test_gpu.py."""

import numpy as np
import pytest

import jax.numpy as jnp

from conftest import load_golden
from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.sequential_mc import (
    MAX_SYMBOLS, frames_per_chunk, sequential_decode)

ALL_CODES = [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("decoder", ["stack", "fano"])
@pytest.mark.parametrize("idx", ALL_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_soft_matches_reference(decoder, idx, mode):
    g = load_golden(f"{decoder}_soft_{idx}_m{mode}.npz")
    out = np.asarray(sequential_decode(decoder, get_code(idx),
                                       jnp.asarray(g["dists"])))
    assert np.array_equal(out, g["decoded"])


@pytest.mark.parametrize("decoder", ["stack", "fano"])
@pytest.mark.parametrize("idx", ALL_CODES)
@pytest.mark.parametrize("mode", [0, 1])
def test_hard_matches_reference(decoder, idx, mode):
    g = load_golden(f"{decoder}_hard_{idx}_m{mode}.npz")
    out = np.asarray(sequential_decode(decoder, get_code(idx),
                                       jnp.asarray(g["received"])))
    assert np.array_equal(out, g["decoded"])


def test_fano_product_rounded_before_add():
    """Inputs on which a contracted FMA in ``1 + w*d`` changes the Fano
    walk (sequential_common.force_rounded)."""
    g = load_golden("fano_fma_regression.npz")
    out = np.asarray(sequential_decode("fano", get_code(0),
                                       jnp.asarray(g["dists"])))
    assert np.array_equal(out, g["decoded"])


def test_rejects_bad_input():
    code = get_code(0)
    T, M = code.num_block_symbols, code.points_per_symbol
    with pytest.raises(ValueError, match="not a sequential decoder"):
        sequential_decode("viterbi", code, jnp.zeros((2, T, M)))
    with pytest.raises(ValueError, match="do not match"):
        sequential_decode("stack", code, jnp.zeros((2, T + 1, M)))
    long = code.replace(block_length=MAX_SYMBOLS)
    with pytest.raises(ValueError, match="exceed"):
        sequential_decode("fano", long,
                          jnp.zeros((2, long.num_block_symbols, M)))


@pytest.mark.parametrize("channel", ["awgn", "bsc"])
def test_chunk_plan_bounds_frames(channel):
    """A chunk holds at most the byte budget of generated frames, at least
    one frame per lane, and never more frames than a lane has."""
    code = get_code("k15-r14-16qam")
    assert frames_per_chunk(code, 8, 3, channel) == 3
    fc = frames_per_chunk(code, 8192, 10 ** 6, channel)
    assert 1 <= fc < 10 ** 6
    assert frames_per_chunk(code, 1 << 30, 5, channel) == 1
