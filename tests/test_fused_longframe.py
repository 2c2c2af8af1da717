"""Fused long-frame MC kernel: bit-level and statistical validation.

The kernel decodes overlapping windows of per-lane coded streams; its
error counts must equal a monolithic XLA Viterbi decode of the *identical*
stream (rebuilt via ops.viterbi_mc.stream_segment_host — same
coordinate-hash RNG, same float expressions).  The coordinate-hash RNG is
additionally checked distributionally (halo consistency needs
position-addressable draws).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from convolutional_codes.models.codebook import get_code
from convolutional_codes.models.trellis import build_trellis
from convolutional_codes.ops.channels import awgn_sigma
from convolutional_codes.ops.viterbi import acs_forward, traceback_from
from convolutional_codes.ops.coord_hash import coord_bits, coord_uniform
from convolutional_codes.ops.viterbi_mc import (
    mc_longframe_viterbi, stream_segment_host)


def monolithic_counts(code, lane_ids, seed, param, channel, W, Wn, nsteps,
                      demapper="soft"):
    span = W + nsteps * Wn + W
    bits, dists = stream_segment_host(code, lane_ids, seed, param, channel,
                                      start=-W, length=span,
                                      demapper=demapper)
    trellis = build_trellis(code)
    B = len(lane_ids)
    init = jnp.zeros((B, trellis.num_states), jnp.float32)
    fm, decs = acs_forward(trellis, dists.astype(jnp.float32), False, init)
    out = traceback_from(trellis, decs,
                         jnp.argmin(fm, axis=-1).astype(jnp.int32))
    pay = slice(W, W + nsteps * Wn)
    return np.asarray(jnp.sum(out[:, pay] != bits[:, pay], axis=1))


CASES = [
    # non-catastrophic codes only: overlap-save streaming decode of an
    # unterminated stream requires the code to remerge after a boundary
    # perturbation (k3-r12's (101,011) shares a (1+D) factor and cannot —
    # the same reason bench.py's config-0 row runs (7,5))
    ("k3-75", "bsc", 0.0125, "soft"),
    ("k3-75", "awgn", float(awgn_sigma(4.0)), "soft"),
    ("k3-75", "awgn", float(awgn_sigma(4.0)), "hard"),
    ("nasa-k7", "awgn", float(awgn_sigma(3.0)), "soft"),
    ("nasa-k7", "bsc", 0.03, "soft"),      # S=64, two decision words
]


@pytest.mark.parametrize("ck,channel,param,dem", CASES)
def test_kernel_counts_match_monolithic(ck, channel, param, dem):
    code = get_code(ck)
    W, Wn, nsteps, lanes = 128, 256, 3, 128
    be, we = mc_longframe_viterbi(code, lanes, nsteps, 7, param,
                                  channel=channel, demapper=dem, window=Wn,
                                  warmup=W, block_lanes=128, interpret=True)
    merr = monolithic_counts(code, np.arange(lanes), 7, param, channel,
                             W, Wn, nsteps, dem)
    assert np.array_equal(np.asarray(be), merr)
    # make sure the case exercises errors at all (except deep-SNR K=7)
    if ck != "nasa-k7":
        assert merr.sum() > 0


def test_deterministic_and_seed_sensitive():
    """Same seed → identical counters (pure counter-based RNG, replayable);
    different seed → different stream."""
    code = get_code("k3-75")
    kw = dict(channel="bsc", window=256, warmup=128, block_lanes=64,
              interpret=True)
    a, _ = mc_longframe_viterbi(code, 64, 4, 11, 0.02, **kw)
    b, _ = mc_longframe_viterbi(code, 64, 4, 11, 0.02, **kw)
    c, _ = mc_longframe_viterbi(code, 64, 4, 12, 0.02, **kw)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))


def test_coord_hash_uniformity():
    """KS + moment checks on the coordinate-hash uniforms, and lag/lane
    correlation bounds — the RNG quality gate for the kernel's channel."""
    lanes = jnp.arange(64, dtype=jnp.uint32)[:, None]
    pos = jnp.arange(16384)[None, :]
    u = np.asarray(coord_uniform(lanes, pos, jnp.uint32(123), 1)).ravel()
    n = u.size
    # KS statistic vs U(0,1)
    s = np.sort(u)
    grid = (np.arange(1, n + 1)) / n
    ks = np.abs(s - grid).max() * np.sqrt(n)
    assert ks < 2.2, ks          # K-S acceptance at ~1e-4 level
    assert abs(u.mean() - 0.5) < 5 / np.sqrt(12 * n)
    # lag-1 (position) and lane-adjacent correlations
    um = u.reshape(64, -1) - 0.5
    lag1 = (um[:, :-1] * um[:, 1:]).mean() * 12
    lane1 = (um[:-1] * um[1:]).mean() * 12
    assert abs(lag1) < 5 / np.sqrt(n), lag1
    assert abs(lane1) < 5 / np.sqrt(n), lane1
    # bit balance of the raw hash
    bits = np.asarray(coord_bits(lanes, pos, jnp.uint32(9), 0))
    ones = sum(((bits >> k) & 1).mean() for k in range(32)) / 32
    assert abs(ones - 0.5) < 4 / np.sqrt(32 * n)


def test_boxmuller_normality():
    """Mean/var/tail of the Box-Muller normals from hashed uniforms."""
    lanes = jnp.arange(8, dtype=jnp.uint32)[:, None]
    pos = jnp.arange(1 << 16)[None, :]
    u0 = coord_uniform(lanes, pos, jnp.uint32(5), 1)
    u1 = coord_uniform(lanes, pos, jnp.uint32(5), 2)
    r = jnp.sqrt(-2.0 * jnp.log(u0))
    z = np.asarray(r * jnp.cos(2 * np.pi * u1)).ravel()
    n = z.size
    assert abs(z.mean()) < 5 / np.sqrt(n)
    assert abs(z.var() - 1.0) < 5 * np.sqrt(2.0 / n)
    # 3-sigma tail mass (0.00270 expected)
    tail = (np.abs(z) > 3).mean()
    assert abs(tail - 0.0027) < 5 * np.sqrt(0.0027 / n)
