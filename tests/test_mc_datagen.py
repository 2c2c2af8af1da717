"""Direct validation of the coordinate-hash MC datagen (ops/mc_datagen).

The sequential kernel's Monte-Carlo frames come from make_datagen, which
rebuilds the encoder shift register via shifted bit-plane views instead of
calling ops/encoder.  These tests pin the datagen against the independent
stage implementations:

  * encoder equality (exact, all six reference codes incl. WSPR K=32 where
    ``bplane << (K-1)`` hits the uint32 edge and the compat quirk masks P1)
    — reference common/encoder.c:84-115;
  * BSC flip semantics at the deterministic extremes and the flip rate —
    binary-symmetric-channel/main.c:61-68;
  * AWGN zero-noise soft/hard demapper equality vs ops/demapper —
    common/demapper.c:61-85, common/hard-demapper.c:66-87;
  * snap-then-distance consistency under real noise (hard vector is the
    distance-table row of the soft vector's strict-less argmin);
  * a statistical BER cross-check of the full datagen chain against the
    independent threefry chain (different RNG, different stage code).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from convolutional_codes.models.codebook import get_code
from convolutional_codes.models.constellations import get_constellation
from convolutional_codes.ops.channels import awgn, awgn_sigma
from convolutional_codes.ops.demapper import hard_demap, soft_demap
from convolutional_codes.ops.encoder import encode
from convolutional_codes.ops.mapper import map_symbols
from convolutional_codes.ops.mc_datagen import frames_host, make_datagen
from convolutional_codes.ops.viterbi import viterbi_decode_soft

GIDS = np.array([0, 1, 2, 7, 63, 100, 12345, 2**20 + 17], np.int64)


def _gen(code, channel, demapper, gids, seed, param):
    T = code.num_block_symbols
    gen = make_datagen(code, T, code.block_length, channel, demapper)
    g = jnp.asarray(gids, jnp.int32)[:, None]
    bits, syms = gen(g, jnp.arange(T)[None, :], jnp.uint32(seed),
                     jnp.float32(param))
    return np.asarray(bits), np.asarray(syms)


@pytest.mark.parametrize("ck", [0, 1, 2, 3, 4, 5])
def test_bsc_zero_noise_equals_encoder(ck):
    """param=0: datagen symbols must EXACTLY equal ops/encoder.encode of
    the datagen bits — the independent tap-matmul encoder, incl. the
    compat-parity quirk codes (1-4) and WSPR's K=32 register."""
    code = get_code(ck)
    bits, syms = _gen(code, "bsc", "soft", GIDS, 42, 0.0)
    ref = np.asarray(encode(code, jnp.asarray(bits[:, :code.block_length])))
    assert np.array_equal(syms, ref)
    # bits must actually vary (the hash is not degenerate)
    assert 0 < bits[:, :code.block_length].mean() < 1


@pytest.mark.parametrize("ck", [0, 4, 5])
def test_bsc_full_flip_and_rate(ck):
    """param=1 flips every coded bit; param=0.25 flips at ~the crossover
    rate (binary-symmetric-channel/main.c:61-68 per-bit independence)."""
    code = get_code(ck)
    m = code.symlen_out
    bits, syms = _gen(code, "bsc", "soft", GIDS, 7, 1.0)
    ref = np.asarray(encode(code, jnp.asarray(bits[:, :code.block_length])))
    assert np.array_equal(syms, ref ^ ((1 << m) - 1))

    gids = np.arange(4096)
    bits, syms = _gen(code, "bsc", "soft", gids, 7, 0.25)
    ref = np.asarray(encode(code, jnp.asarray(bits[:, :code.block_length])))
    xor = syms ^ ref
    flips = sum(((xor >> k) & 1).sum() for k in range(m))
    n = xor.size * m
    z = (flips / n - 0.25) / np.sqrt(0.25 * 0.75 / n)
    assert abs(z) < 5, (flips / n, z)


@pytest.mark.parametrize("ck", [0, 4, 5, "k15-r14-16qam"])
@pytest.mark.parametrize("dem", ["soft", "hard"])
def test_awgn_zero_noise_equals_demapper(ck, dem):
    """param=0: the datagen distance planes must equal ops/demapper applied
    to the mapped ops/encoder symbols (QPSK, 8-QAM, 16-QAM tables)."""
    code = get_code(ck)
    bits, syms = _gen(code, "awgn", dem, GIDS, 11, 0.0)
    tx = map_symbols(code, encode(code, jnp.asarray(bits[:, :code.block_length])))
    demapf = soft_demap if dem == "soft" else hard_demap
    ref = np.asarray(demapf(code.symlen_out, tx))
    # datagen multiplies by 1/ndist where ops/demapper divides by ndist —
    # equal up to an ulp when ndist is not a power of two (8-QAM, 16-QAM)
    np.testing.assert_allclose(syms, ref, rtol=3e-7, atol=0)


@pytest.mark.parametrize("ck", [0, 5, "k15-r14-16qam"])
def test_awgn_hard_is_snap_of_soft(ck):
    """Under real noise the hard vector must be the distance-table row of
    the soft vector's argmin (strict-less, first wins —
    hard-demapper.c:66-87): soft and hard datagen share the same
    coordinate-hash noise draw, so the snap decision is checkable
    independently of the RNG."""
    code = get_code(ck)
    m = code.symlen_out
    gids = np.arange(512)
    sigma = float(awgn_sigma(5.0))
    _, soft_d = _gen(code, "awgn", "soft", gids, 3, sigma)
    _, hard_d = _gen(code, "awgn", "hard", gids, 3, sigma)
    # distance-table rows via ops/demapper on the constellation itself
    pts = jnp.asarray(get_constellation(m))
    table = np.asarray(soft_demap(m, pts))          # [2^m, 2^m]
    snap_idx = np.argmin(soft_d, axis=-1)           # first-min == strict-less
    np.testing.assert_allclose(hard_d, table[snap_idx], rtol=3e-7, atol=0)
    assert len(np.unique(snap_idx)) > 1


def test_awgn_ber_cross_check_vs_threefry_chain():
    """Statistical independence check: Viterbi BER on datagen frames vs the
    threefry modular chain (different RNG, independent encoder/channel/
    demapper code) at 4 dB must agree within cluster-corrected MC bounds —
    a datagen bug in the noise scale/normalization moves BER decades."""
    code = get_code(0)
    sigma = float(awgn_sigma(4.0))
    N = 16384
    L = code.block_length

    bits_a, syms_a = frames_host(code, np.arange(N), 99, sigma, "awgn")
    dec_a = np.asarray(viterbi_decode_soft(code, jnp.asarray(syms_a)))
    ber_a = (dec_a != bits_a[:, :L]).mean()

    key = jax.random.PRNGKey(5)
    kb, kn = jax.random.split(key)
    bits_b = jax.random.bernoulli(kb, 0.5, (N, L)).astype(jnp.int32)
    rx = awgn(kn, map_symbols(code, encode(code, bits_b)), sigma)
    dec_b = np.asarray(viterbi_decode_soft(code, soft_demap(code.symlen_out, rx)))
    ber_b = (dec_b != np.asarray(bits_b)).mean()

    n = N * L
    p = (ber_a + ber_b) / 2
    cluster = 8.0          # decoder errors arrive in per-frame bursts
    z = (ber_a - ber_b) / np.sqrt(cluster * p * (1 - p) * 2 / n)
    assert abs(z) < 5, (ber_a, ber_b, z)
    assert ber_a > 0 and ber_b > 0
