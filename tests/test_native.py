"""Native C runtime vs goldens + fuzz cross-check against the JAX path."""

import zlib

import numpy as np
import pytest

from conftest import load_golden
from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.encoder import encode
from convolutional_codes.ops.viterbi import viterbi_decode_soft, viterbi_decode_hard
from convolutional_codes.utils import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C compiler / native lib")


@pytest.mark.parametrize("idx", range(6))
def test_native_encoder_matches_goldens(idx):
    g = load_golden(f"enc_{idx}.npz")
    code = get_code(idx)
    out = native.encode_blocks(code, g["bits"])
    assert np.array_equal(out, g["symbols"])


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("mode", [0, 1])
def test_native_viterbi_matches_goldens(idx, mode):
    code = get_code(idx)
    gs = load_golden(f"viterbi_soft_{idx}_m{mode}.npz")
    assert np.array_equal(native.viterbi_soft_blocks(code, gs["dists"]),
                          gs["decoded"])
    gh = load_golden(f"viterbi_hard_{idx}_m{mode}.npz")
    bits, metrics = native.viterbi_hard_blocks(code, gh["received"].astype(np.int32))
    assert np.array_equal(bits, gh["decoded"])
    assert np.array_equal(metrics, gh["metrics"])


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("mode", [0, 1])
def test_native_stack_matches_goldens(idx, mode):
    code = get_code(idx)
    gs = load_golden(f"stack_soft_{idx}_m{mode}.npz")
    assert np.array_equal(native.stack_soft_blocks(code, gs["dists"]),
                          gs["decoded"])
    gh = load_golden(f"stack_hard_{idx}_m{mode}.npz")
    assert np.array_equal(
        native.stack_hard_blocks(code, gh["received"].astype(np.int32)),
        gh["decoded"])


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("mode", [0, 1])
def test_native_fano_matches_goldens(idx, mode):
    code = get_code(idx)
    gs = load_golden(f"fano_soft_{idx}_m{mode}.npz")
    bits, _ = native.fano_soft_blocks(code, gs["dists"])
    assert np.array_equal(bits, gs["decoded"])
    gh = load_golden(f"fano_hard_{idx}_m{mode}.npz")
    bits, _ = native.fano_hard_blocks(code, gh["received"].astype(np.int32))
    assert np.array_equal(bits, gh["decoded"])


@pytest.mark.parametrize("idx", [0, 3, 5, "nasa-k7"])
def test_fuzz_jax_vs_native(idx):
    """Random-input fuzz: JAX pipeline must agree with the native oracle."""
    code = get_code(idx)
    rng = np.random.default_rng(zlib.crc32(str(idx).encode()))
    N, T, M = 64, code.num_block_symbols, code.points_per_symbol

    bits = rng.integers(0, 2, size=(N, code.block_length))
    assert np.array_equal(np.asarray(encode(code, bits)),
                          native.encode_blocks(code, bits))

    dists = rng.random((N, T, M)).astype(np.float32)
    assert np.array_equal(np.asarray(viterbi_decode_soft(code, dists)),
                          native.viterbi_soft_blocks(code, dists))

    rx = rng.integers(0, M, size=(N, T)).astype(np.int32)
    jb, jm = viterbi_decode_hard(code, rx)
    nb, nm = native.viterbi_hard_blocks(code, rx)
    assert np.array_equal(np.asarray(jb), nb)
    assert np.array_equal(np.asarray(jm), nm)


@pytest.mark.parametrize("idx", [0, 3, 5, "k9-r12"])
def test_fuzz_sequential_jax_vs_native(idx):
    """Deep fuzz of the JAX stack/Fano decoders against the native oracle:
    hundreds of noisy-codeword frames per code — two orders of magnitude
    beyond the pinned golden corpus, feasible because the oracle is C
    (tests/golden_model.py is the spec the oracle was validated against)."""
    import jax.numpy as jnp
    from convolutional_codes.ops.fano import fano_decode_soft, fano_decode_hard
    from convolutional_codes.ops.stack import stack_decode_soft, stack_decode_hard
    from convolutional_codes.models.constellations import get_constellation

    code = get_code(idx)
    rng = np.random.default_rng(zlib.crc32(f"seqfuzz-{idx}".encode()))
    N, T, M = 256, code.num_block_symbols, code.points_per_symbol

    # noisy codewords (realistic search trees), plus pure-noise tails
    bits = rng.integers(0, 2, size=(N, code.block_length))
    syms = native.encode_blocks(code, bits)
    const = np.asarray(get_constellation(code.symlen_out), np.float32)
    iq = const[syms] + rng.normal(0.0, 0.45, (N, T, 2)).astype(np.float32)
    d = iq[:, :, None, :] - const
    ndist = ((const[0] - const[1]) ** 2).sum()
    dists = ((d * d).sum(-1) / ndist).astype(np.float32)
    dists[N - 16:] = rng.random((16, T, M), np.float32) * 4.0  # adversarial

    assert np.array_equal(np.asarray(stack_decode_soft(code, jnp.asarray(dists))),
                          native.stack_soft_blocks(code, dists))
    jf = np.asarray(fano_decode_soft(code, jnp.asarray(dists)))
    nf, _ = native.fano_soft_blocks(code, dists)
    assert np.array_equal(jf, nf)

    flips = (rng.random((N, T)) < 0.04) * rng.integers(0, M, (N, T))
    rx = (syms ^ flips).astype(np.int32)
    assert np.array_equal(np.asarray(stack_decode_hard(code, jnp.asarray(rx))),
                          native.stack_hard_blocks(code, rx))
    jf = np.asarray(fano_decode_hard(code, jnp.asarray(rx)))
    nf, _ = native.fano_hard_blocks(code, rx)
    assert np.array_equal(jf, nf)
