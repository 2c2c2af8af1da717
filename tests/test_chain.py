"""Mapper / demapper / channel stages vs golden model + closed form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import golden_model as gm
from convolutional_codes.models.codebook import get_code
from convolutional_codes.models.constellations import get_constellation, min_sq_distance
from convolutional_codes.ops.mapper import map_symbols, map_symbols_m
from convolutional_codes.ops.demapper import soft_demap, hard_demap, hard_decide
from convolutional_codes.ops.channels import awgn, bsc, awgn_sigma


def test_constellations_unit_power_and_values():
    for m in (1, 2, 3):
        c = get_constellation(m)
        assert c.shape == (1 << m, 2)
        power = (c ** 2).sum(axis=1).mean()
        assert abs(power - 1.0) < 2e-5
    # normalization constants (demapper.c:42-45 definition)
    assert abs(min_sq_distance(1) - 4.0) < 1e-5
    assert abs(min_sq_distance(2) - 2.0) < 1e-5
    assert abs(min_sq_distance(3) - 2.0 / 3.0) < 1e-5


@pytest.mark.parametrize("m", [1, 2, 3])
def test_mapper_demapper_vs_golden(m):
    rng = np.random.default_rng(m)
    syms = rng.integers(0, 1 << m, size=(4, 50))
    iq = np.asarray(map_symbols_m(m, jnp.asarray(syms)))
    assert np.array_equal(iq, gm.map_symbols(m, syms))
    noisy = (iq + rng.normal(0, 0.5, iq.shape)).astype(np.float32)
    soft = np.asarray(soft_demap(m, jnp.asarray(noisy)))
    np.testing.assert_allclose(soft, gm.soft_demap(m, noisy), rtol=1e-6, atol=1e-6)
    hard = np.asarray(hard_demap(m, jnp.asarray(noisy)))
    np.testing.assert_allclose(hard, gm.hard_demap(m, noisy), rtol=1e-6, atol=1e-6)


def test_map_symbols_with_code():
    code = get_code(5)  # symlen 3 → 8-QAM
    syms = np.arange(8)[None, :]
    iq = np.asarray(map_symbols(code, jnp.asarray(syms)))
    assert np.array_equal(iq[0], get_constellation(3))


def test_noiseless_demap_identifies_symbol():
    for m in (1, 2, 3):
        syms = jnp.arange(1 << m)[None, :]
        iq = map_symbols_m(m, syms)
        assert np.array_equal(np.asarray(hard_decide(m, iq))[0], np.arange(1 << m))
        d = np.asarray(soft_demap(m, iq))[0]
        assert np.allclose(np.diagonal(d), 0.0, atol=1e-9)


def test_awgn_statistics():
    key = jax.random.PRNGKey(0)
    iq = jnp.zeros((64, 256, 2), jnp.float32)
    sigma = awgn_sigma(8.0)  # 0.2815... (AWGN-channel/main.c:157-160)
    assert abs(float(sigma) - 0.281504279937367) < 1e-6
    noisy = np.asarray(awgn(key, iq, sigma))
    assert abs(noisy.std() - float(sigma)) < 0.01 * float(sigma) * 5
    assert abs(noisy.mean()) < 1e-3
    # uncoded Es/N0 → Eb/N0 conversion (uncoded/main.c:150-153)
    s3 = awgn_sigma(8.0, info_bits_per_symbol=3)
    assert abs(float(s3) - 0.281504279937367 / np.sqrt(3.0)) < 1e-6


def test_bsc_statistics_and_masking():
    key = jax.random.PRNGKey(1)
    syms = jnp.zeros((512, 420), jnp.int32)
    rx = np.asarray(bsc(key, syms, 0.1, num_bits=2))
    assert rx.max() <= 3
    rate = (np.unpackbits(rx.astype(np.uint8)[..., None], axis=-1)[..., -2:]).mean()
    assert abs(rate - 0.1) < 0.005
    rx0 = np.asarray(bsc(key, syms, 0.0, num_bits=2))
    assert np.array_equal(rx0, np.asarray(syms))


def test_bpsk_symlen1_code_end_to_end():
    """Constellation 1 (diagonal BPSK) through the full chain with a
    user-defined rate-1/1 K=3 code — the reference ships the table
    (constellations.c:8-11) but no code reaches it."""
    import jax
    from convolutional_codes.models.codebook import Code, register_code
    from convolutional_codes.ops.encoder import encode
    from convolutional_codes.ops.viterbi import viterbi_decode_soft

    bpsk_code = Code(name="bpsk-k3", symlen_out=1, constraint_length=3,
                     block_length=32, polynomials=(0b111,), parity="true")
    register_code("bpsk-k3", bpsk_code, overwrite=True)
    key = jax.random.PRNGKey(6)
    bits = jax.random.bernoulli(key, 0.5, (16, 32)).astype(jnp.int32)
    syms = encode(bpsk_code, bits)
    iq = map_symbols(bpsk_code, syms)
    assert np.asarray(iq).shape == (16, 34, 2)
    rx = awgn(key, iq, awgn_sigma(6.0))
    dists = soft_demap(1, rx)
    dec = viterbi_decode_soft(bpsk_code, dists)
    # rate-1 repetition-free code still decodes mostly correctly at 6 dB
    assert float((np.asarray(dec) != np.asarray(bits)).mean()) < 0.1
