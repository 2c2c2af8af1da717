"""Symbol → constellation-point mapper (batched gather).

Reference: one (I, Q) float pair per symbol via table lookup
(``common/mapper.c:54-71``); constellation selected by bits-per-symbol
(``mapper.c:45``).  Here: a single gather over the whole batch.
"""

from __future__ import annotations

import jax.numpy as jnp

from convolutional_codes.models.codebook import Code
from convolutional_codes.models.constellations import get_constellation


def map_symbols(code: Code, symbols: jnp.ndarray) -> jnp.ndarray:
    """``[..., T]`` symbol indices → ``[..., T, 2]`` float32 (I, Q)."""
    points = jnp.asarray(get_constellation(code.symlen_out))
    return points[symbols]


def map_symbols_m(num_bits: int, symbols: jnp.ndarray) -> jnp.ndarray:
    """Same, keyed by bits-per-symbol (for the uncoded chain)."""
    points = jnp.asarray(get_constellation(num_bits))
    return points[symbols]
