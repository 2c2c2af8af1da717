"""Bit-level helpers shared by encoder/decoders (JAX + NumPy).

The reference packs info bits MSB-first within bytes everywhere
(``encoder.c:87``, ``viterbi-decoder.c:88``); in this framework bits live
as unpacked ``[batch, L]`` int arrays in {0,1} on device, and these helpers
convert at the host boundary / compute parities and popcounts in int32 lanes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def pack_bits_msb(bits: np.ndarray) -> np.ndarray:
    """[..., L] bits {0,1} → [..., ceil(L/8)] uint8, MSB-first per byte."""
    return np.packbits(np.asarray(bits, dtype=np.uint8), axis=-1, bitorder="big")


def unpack_bits_msb(data: np.ndarray, num_bits: int) -> np.ndarray:
    """[..., nbytes] uint8 → [..., num_bits] bits, MSB-first per byte."""
    bits = np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1, bitorder="big")
    return bits[..., :num_bits]


def popcount32(x: jnp.ndarray) -> jnp.ndarray:
    """Per-element population count of (u)int32 lanes (SWAR, like the
    reference's Hamming popcount in binary-symmetric-channel/viterbi-decoder.c:68-72,
    widened from 8 to 32 bits)."""
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def parity32(x: jnp.ndarray) -> jnp.ndarray:
    """Per-element parity of (u)int32 lanes."""
    x = x.astype(jnp.uint32)
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return (x & jnp.uint32(1)).astype(jnp.int32)
