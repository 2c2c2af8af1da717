"""16-QAM constellation extension (BASELINE.json config 5).

The reference stops at 3 bits/symbol (``common/constellations.c:6-32``);
the framework adds a square Gray 16-QAM table plus user-registrable
constellations.  Checks: table invariants, uncoded BER vs the exact
closed form, and the K=15 rate-1/4 + 16-QAM mapped chain end-to-end.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convolutional_codes.models.codebook import get_code
from convolutional_codes.models.constellations import (
    get_constellation, min_sq_distance, register_constellation)


def test_16qam_table_invariants():
    pts = get_constellation(4)
    assert pts.shape == (16, 2)
    # unit average power
    assert abs(float((pts ** 2).sum(1).mean()) - 1.0) < 1e-6
    # ndist (reference definition: |p0 - p1|^2) equals the true minimum
    d2 = ((pts[None, :, :] - pts[:, None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    assert abs(min_sq_distance(4) - float(d2.min())) < 1e-6
    # Gray property: every nearest neighbor differs in exactly one bit
    for s in range(16):
        for n in np.nonzero(np.isclose(d2[s], d2.min()))[0]:
            assert bin(s ^ int(n)).count("1") == 1


def test_register_constellation_validates():
    with pytest.raises(KeyError):
        register_constellation(4, get_constellation(4))  # already present
    with pytest.raises(ValueError):
        register_constellation(5, np.zeros((7, 2)))      # wrong shape


def _qfunc(x):
    return 0.5 * math.erfc(x / math.sqrt(2.0))


def test_uncoded_16qam_matches_closed_form():
    """Gray 16-QAM uncoded BER = 1/4 [3Q(a/s) + 2Q(3a/s) - Q(5a/s)] per bit
    (per-axis 4-PAM with Gray labels), a = 1/sqrt(10)."""
    from convolutional_codes.ops.channels import awgn_sigma
    from convolutional_codes.sim.chain import make_uncoded_step

    ebn0 = 6.0
    sigma = float(awgn_sigma(ebn0, info_bits_per_symbol=4))
    a = 1.0 / math.sqrt(10.0)
    q1, q3, q5 = (_qfunc(k * a / sigma) for k in (1, 3, 5))
    expected = 0.25 * (3 * q1 + 2 * q3 - q5)

    step = make_uncoded_step(4, frames=1 << 16)
    be = nb = 0
    for i in range(24):
        b, _, n = step(jax.random.fold_in(jax.random.PRNGKey(3), i),
                       jnp.float32(sigma))
        be += int(b)
        nb += int(n)
    ber = be / nb
    # binomial z with a 2x margin for the intra-symbol bit correlation
    z = abs(ber - expected) / math.sqrt(expected * (1 - expected) / nb)
    assert z < 9.0, (ber, expected, z)


def test_k15_r14_16qam_chain_roundtrip():
    """Noiseless mapped chain through the K=15 rate-1/4 code: encoder →
    16-QAM mapper → soft demapper → fano decode recovers the input."""
    from convolutional_codes.ops.demapper import soft_demap
    from convolutional_codes.ops.encoder import encode
    from convolutional_codes.ops.fano import fano_decode_soft
    from convolutional_codes.ops.mapper import map_symbols

    code = get_code("k15-r14-16qam")
    assert code.points_per_symbol == 16
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(4, code.block_length))
    iq = map_symbols(code, jnp.asarray(np.asarray(encode(code, bits))))
    dists = soft_demap(4, iq)
    dec = fano_decode_soft(code, dists)
    assert np.array_equal(np.asarray(dec), bits)


def test_k15_r14_16qam_point_step_runs():
    """One noisy sweep step of the config-5 chain produces sane counters."""
    from convolutional_codes.ops.channels import awgn_sigma
    from convolutional_codes.sim.chain import make_point_step

    code = get_code("k15-r14-16qam")
    step = make_point_step(code, "awgn", "fano", "soft", frames=8,
                           timeout_per_bit=100)
    be, fe, nb = step(jax.random.PRNGKey(0), jnp.float32(awgn_sigma(12.0)))
    assert int(nb) == 8 * code.block_length
    assert 0 <= int(be) <= int(nb)


def test_k15_r14_16qam_fano_weight_tuned():
    """Regression for a mistuned weight (fano_metric_weight=-40): with
    16-QAM's ndist = 0.4, E[dist|correct] = 5x the QPSK value at equal
    Eb/N0, and a too-deep weight makes every Fano walk below 12 dB exhaust
    its budget (a FER=1.0 plateau at 6-9.5 dB).
    With the tuned default, 8 dB decodes must be clean and cheap — no
    timeouts, zero errors, ~1 search step per symbol."""
    from convolutional_codes.ops.channels import awgn, awgn_sigma
    from convolutional_codes.ops.demapper import soft_demap
    from convolutional_codes.ops.encoder import encode
    from convolutional_codes.ops.fano import fano_decode_soft_with_diag
    from convolutional_codes.ops.mapper import map_symbols

    code = get_code("k15-r14-16qam")
    # the tuned weight keeps the correct-path metric positive in
    # expectation at the 6 dB design point: 1 + w * 2 sigma^2 / ndist > 0
    sigma6 = float(awgn_sigma(6.0))
    assert 1.0 + code.fano_metric_weight * 2 * sigma6 ** 2 / 0.4 > 0

    B = 64
    key = jax.random.PRNGKey(2)
    kb, kc = jax.random.split(key)
    bits = jax.random.bernoulli(kb, 0.5, (B, code.block_length)).astype(jnp.int32)
    rx = awgn(kc, map_symbols(code, encode(code, bits)), awgn_sigma(8.0))
    dec, diag = fano_decode_soft_with_diag(code, soft_demap(4, rx),
                                           timeout_per_bit=300)
    assert not bool(np.asarray(diag["timed_out"]).any())
    assert np.array_equal(np.asarray(dec), np.asarray(bits))


def test_register_overwrite_clears_dependent_caches():
    """Kernels and jitted runners built before a re-registration embed the
    old point table; overwrite must clear those caches."""
    from convolutional_codes.models import constellations as con
    from convolutional_codes.ops import sequential_mc, viterbi_mc
    from convolutional_codes.parallel.montecarlo import _fused_runner

    code = get_code(0)
    viterbi_mc._call(code, 64, 64, "awgn", "soft", None, 0, True)
    sequential_mc._jitted("stack", code, 8, 1, "awgn", "soft", 0)
    assert viterbi_mc._call.cache_info().currsize >= 1
    assert sequential_mc._jitted.cache_info().currsize >= 1
    orig = con.get_constellation(code.symlen_out).copy()
    try:
        con.register_constellation(code.symlen_out, orig, overwrite=True)
        assert viterbi_mc._call.cache_info().currsize == 0
        assert sequential_mc._jitted.cache_info().currsize == 0
        assert _fused_runner.cache_info().currsize == 0
    finally:
        con.register_constellation(code.symlen_out, orig, overwrite=True)
