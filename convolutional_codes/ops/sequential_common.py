"""Shared machinery for the batched sequential decoders (stack, Fano).

Big-constraint codes (WSPR K=32 → 2^31 states) rule out dense trellis
tables, so sequential decoders evaluate expected symbols *dynamically* from
the encoder state with closed-form int32/uint32 register math — including
the reference's compat-parity quirk — elementwise over the batch.

Register convention matches models.trellis: ``r = state | input << (K-1)``
(newest bit at K-1), successor state ``r >> 1`` — the low-bit image of the
reference's 64-bit register (``AWGN-channel/stack-decoder.c:249-272``,
``fano-decoder.c:288-311``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax.numpy as jnp
import numpy as np

from convolutional_codes.models.codebook import Code, PARITY_COMPAT
from convolutional_codes.models.trellis import quirk_mask_low
from convolutional_codes.utils.bitops import parity32, popcount32


def make_branch_fn(code: Code) -> Callable[[jnp.ndarray, int], Tuple[jnp.ndarray, jnp.ndarray]]:
    """Returns ``branch(state_u32, input_bit) -> (next_state_u32, esym_i32)``.

    ``state`` is a uint32 array of K-1-bit encoder states; ``input_bit`` a
    Python int (0/1).  Fully vectorized; symbols pack polynomial 0 at the MSB
    like the encoder.
    """
    K = code.constraint_length
    compat = code.parity == PARITY_COMPAT
    qmask = jnp.uint32(quirk_mask_low(K)) if compat else None
    polys = [jnp.uint32(p) for p in code.polynomials]

    def branch(state: jnp.ndarray, input_bit: int):
        state = state.astype(jnp.uint32)
        r = state | (jnp.uint32(input_bit) << (K - 1))
        sym = jnp.zeros(state.shape, jnp.int32)
        for p in polys:
            x = r & p
            b = parity32(x)
            if compat:
                b = b * (1 - parity32(x & qmask))
            sym = (sym << 1) | b
        return r >> 1, sym

    return branch


#: float32 max — see :func:`force_rounded` below.
F32_MAX = np.float32(3.4028235e38)


def force_rounded(p: jnp.ndarray) -> jnp.ndarray:
    """Identity on float32 values that forces ``p`` to be rounded *before*
    any subsequent add.  XLA's CPU emitter contracts ``a*b + c`` into an
    FMA (single rounding), which deviates from the behavioral spec: the
    reference binaries (and tests/golden_model.py / the native oracle)
    round the product first.  ``min(p, F32_MAX)`` is a real instruction
    neither XLA's simplifier nor LLVM can fold away (no value-range proof),
    so the mul can no longer fuse with the add.  Verified to restore
    bit-identical ``1 + w*d`` on all divergent inputs."""
    return jnp.minimum(p, F32_MAX)


def soft_transition_metrics(weight: float, dists_row: jnp.ndarray,
                            esym0: jnp.ndarray, esym1: jnp.ndarray):
    """``1 + weight * dist[esym]`` per branch (stack-decoder.c:274,
    fano-decoder.c:309).  dists_row: [B, 2^m] float32.  The product is
    rounded before the add (spec semantics, not FMA) — see
    :func:`force_rounded`."""
    d0 = jnp.take_along_axis(dists_row, esym0[:, None], axis=1)[:, 0]
    d1 = jnp.take_along_axis(dists_row, esym1[:, None], axis=1)[:, 0]
    w = jnp.float32(weight)
    return 1.0 + force_rounded(w * d0), 1.0 + force_rounded(w * d1)


def hard_transition_metrics(bit_metrics, symlen: int, rx_row: jnp.ndarray,
                            esym0: jnp.ndarray, esym1: jnp.ndarray):
    """``hamming * wrong + (symlen - hamming) * correct``
    (binary-symmetric-channel/stack-decoder.c:267-272).  rx_row: [B] int."""
    correct, wrong = int(bit_metrics[0]), int(bit_metrics[1])
    h0 = popcount32(esym0 ^ rx_row)
    h1 = popcount32(esym1 ^ rx_row)
    tm0 = h0 * wrong + (symlen - h0) * correct
    tm1 = h1 * wrong + (symlen - h1) * correct
    return tm0.astype(jnp.int32), tm1.astype(jnp.int32)
