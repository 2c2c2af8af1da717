"""Soft and hard demappers (batched, fused distance computation).

Soft (reference ``common/demapper.c:61-85``): for each received (I, Q) emit
the vector of squared Euclidean distances to every constellation point,
normalized by ``ndist`` — the squared distance between points 0 and 1
(``demapper.c:42-45``).  This distance vector *is* the decoder's symbol
metric input.

Hard (reference ``common/hard-demapper.c:66-87``): snap the received point to
the nearest constellation point first (ties: lowest index, strict-less scan),
then emit the distance vector of the snapped point.  Downstream soft decoders
run unchanged, yielding hard-decision curves.
"""

from __future__ import annotations

import jax.numpy as jnp

from convolutional_codes.models.constellations import get_constellation, min_sq_distance


def _sq_distances(iq: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    d = iq[..., None, :] - points            # [..., 2^m, 2]
    return (d * d).sum(-1)                   # [..., 2^m]


def soft_demap(num_bits: int, iq: jnp.ndarray) -> jnp.ndarray:
    """``[..., T, 2]`` received (I,Q) → ``[..., T, 2^m]`` normalized sq-dists."""
    points = jnp.asarray(get_constellation(num_bits))
    return _sq_distances(iq, points) / jnp.float32(min_sq_distance(num_bits))


def hard_decide(num_bits: int, iq: jnp.ndarray) -> jnp.ndarray:
    """Nearest constellation point index per received (I,Q): ``[..., T]`` int32."""
    points = jnp.asarray(get_constellation(num_bits))
    return jnp.argmin(_sq_distances(iq, points), axis=-1).astype(jnp.int32)


def hard_demap(num_bits: int, iq: jnp.ndarray) -> jnp.ndarray:
    """Snap-then-distance demapper. Same output type as :func:`soft_demap`."""
    points = jnp.asarray(get_constellation(num_bits))
    snapped = points[hard_decide(num_bits, iq)]
    return _sq_distances(snapped, points) / jnp.float32(min_sq_distance(num_bits))
