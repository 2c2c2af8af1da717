"""Coordinate-hash random numbers for the Monte-Carlo kernels.

All randomness of the kernel paths is a pure counter hash of (seed, frame
or lane id, symbol position, draw salt): two rounds of the murmur3
finalizer over a Weyl-mixed counter, built from plain 32-bit integer ops.
Because a draw is addressed by its coordinates and not by a stream, the
same (frame, position) yields the same bits in a kernel, in an XLA replica
and in interpret mode, and overlapping windows replay identical data.
Distribution-level equivalence with the reference's RNG is the contract
(SURVEY.md §2e).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

TWO_PI = 2.0 * math.pi


def _fmix32(x: jnp.ndarray) -> jnp.ndarray:
    """murmur3 32-bit finalizer (public-domain constants)."""
    x = x ^ (x >> 16)
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def coord_bits(lane: jnp.ndarray, pos: jnp.ndarray, seed: jnp.ndarray,
               salt: int) -> jnp.ndarray:
    """uint32 hash of (seed, lane, pos, salt): two finalizer rounds over a
    Weyl-mixed counter.  ``lane``/``pos`` broadcast against each other."""
    c = (pos.astype(jnp.uint32) * np.uint32(0x9E3779B9)
         ^ lane.astype(jnp.uint32) * np.uint32(0x7FEB352D))
    c = c + seed.astype(jnp.uint32) + np.uint32((salt * 0x68E31DA4) & 0xFFFFFFFF)
    return _fmix32(_fmix32(c) ^ lane.astype(jnp.uint32))


def coord_uniform(lane, pos, seed, salt) -> jnp.ndarray:
    """(0, 1) float32 with 31-bit resolution, never 0.  31 bits let
    Box-Muller reach ~6.6 sigma (Q(6.6) ~ 2e-11, below every published BER
    point); a 24-bit mantissa would truncate Gaussian tails at 5.9 sigma."""
    bits = (coord_bits(lane, pos, seed, salt) >> 1).astype(jnp.int32)
    return (bits.astype(jnp.float32) * jnp.float32(2.0 ** -31)
            + jnp.float32(2.0 ** -32))
