"""Batched convolutional encoder as a windowed tap-count matmul.

The reference encoder walks a 64-bit shift register one input bit at a time
(``common/encoder.c:84-118``): MSB-first intake, parity of register &
polynomial per output bit, auto-appended K-1 zero tail, emitting
``block_len + K - 1`` symbols per block.

Vectorized formulation: each output symbol t depends only on the input window
``b[t], b[t-1], ..., b[t-K+1]`` (zeros outside [0, L)).  Output bit n is
``parity(sum_j window[j] * taps[j, n])`` — an integer correlation followed by
mod 2 — and the compat-parity quirk adds a second correlation with the
quirk-masked taps (see models.trellis.encoder_taps).  The whole block is one
``[B*T, K] x [K, m]`` matmul + mod-2, with no sequential dependence, no
64-bit registers, and batch parallelism over frames.  This also covers K up
to 32 (WSPR) where per-state tables would not fit.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from convolutional_codes.models.codebook import Code
from convolutional_codes.models.trellis import encoder_taps


@functools.lru_cache(maxsize=None)
def _host_tables(code: Code, length: int, terminate: bool):
    taps, qtaps = encoder_taps(code)
    K = code.constraint_length
    T = length + (K - 1 if terminate else 0)
    # windows[t, j] = padded[t + K-1 - j] where padded has K-1 leading zeros
    idx = (K - 1) + np.arange(T)[:, None] - np.arange(K)[None, :]
    has_quirk = bool(qtaps.any())
    # Symbol packing: polynomial 0 at symbol MSB (encoder.c:102-105).
    weights = (1 << np.arange(code.symlen_out - 1, -1, -1)).astype(np.int32)
    return taps, qtaps, idx.astype(np.int32), has_quirk, weights


def encode(code: Code, bits: jnp.ndarray) -> jnp.ndarray:
    """Encode info bits into channel symbols.

    Args:
      code: the code definition.
      bits: ``[..., block_length]`` int array in {0, 1} (MSB-first order of
        the reference byte stream is the caller's concern; on device bits are
        unpacked).

    Returns:
      ``[..., block_length + K - 1]`` int32 symbols in [0, 2^symlen_out).
    """
    if bits.shape[-1] != code.block_length:
        raise ValueError(f"expected {code.block_length} info bits, "
                         f"got {bits.shape[-1]}")
    return encode_stream(code, bits, terminate=True)


def encode_stream(code: Code, bits: jnp.ndarray, terminate: bool = True
                  ) -> jnp.ndarray:
    """Encode an arbitrary-length bit stream (streaming / long-frame mode —
    no reference counterpart; the reference caps blocks at uint8 lengths,
    SURVEY.md §2d).  ``terminate`` appends the K-1 zero tail flush."""
    L = int(bits.shape[-1])
    taps, qtaps, idx, has_quirk, weights = _host_tables(code, L, terminate)
    K = code.constraint_length
    bits = bits.astype(jnp.int32)
    # K-1 leading zeros (empty register) + optional K-1 tail-flush zeros.
    pad = [(0, 0)] * (bits.ndim - 1) + [(K - 1, K - 1 if terminate else 0)]
    padded = jnp.pad(bits, pad)
    windows = padded[..., idx]                         # [..., T, K]
    counts = windows @ jnp.asarray(taps)               # [..., T, m]
    out_bits = counts & 1
    if has_quirk:
        qcounts = windows @ jnp.asarray(qtaps)
        out_bits = out_bits * (1 - (qcounts & 1))
    return (out_bits * jnp.asarray(weights)).sum(-1).astype(jnp.int32)
