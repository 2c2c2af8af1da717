"""Sequential Monte-Carlo points (ops/sequential_mc) on the device mesh.

The reference's sequential decoders are single-threaded host loops
(AWGN-channel/{fano,stack}-decoder.c).  This module puts their kernel
under a shard_map so the dominant-cost sweeps use every device:

  * the global lane set of each sweep point is split into contiguous
    per-device blocks, each device receiving a ``lane0`` offset so it
    generates a distinct block of the SAME global frame-id space — a
    sharded run is therefore **bit-identical** to the serial same-seed
    ``mc_fano``/``mc_stack`` run (tests/test_seq_grid.py), not just
    statistically equal;
  * R sweep points (same sample tier) run concurrently on ``ndev / R``
    devices each — seeds and channel parameters are per-device values,
    so one compiled executable serves every grouping.

Counters come back per device; the host reduces them per point in int64.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from convolutional_codes.models.codebook import Code
from convolutional_codes.models.constellations import register_dependent_cache
from convolutional_codes.ops.fano import FANO_TIMEOUT
from convolutional_codes.ops.sequential_mc import chunk_counts, frames_per_chunk


@lru_cache(maxsize=None)
def _seq_grid_step(decoder: str, code: Code, Bl: int, fc: int, channel: str,
                   demapper: str, timeout_per_bit: int, mesh: Mesh):
    """One jitted mesh-wide chunk: every device decodes ``fc`` frames of
    each of its ``Bl`` lanes."""
    run = chunk_counts(decoder, code, Bl, fc, channel, demapper,
                       timeout_per_bit)
    axes = tuple(mesh.axis_names)

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P(axes), P(axes), P(axes), P(), P()),
             out_specs=(P(axes), P(axes)), check_vma=False)
    def step(seed, param, lane0, f0, fpl):
        be, fe = run(seed[0], param[0], lane0[0], f0, fpl)
        return be[None], fe[None]

    return step


# the datagen embeds the constellation tables
register_dependent_cache(_seq_grid_step.cache_clear)


def seq_mc_grid(decoder: str, code: Code, lanes: int, frames_per_lane: int,
                seeds: Sequence[int], params: Sequence[float], mesh: Mesh,
                channel: str = "awgn", demapper: str = "soft",
                timeout_per_bit: int = FANO_TIMEOUT
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run ``R = len(seeds)`` sequential sweep points across ``mesh``.

    ``lanes`` is the GLOBAL lane count per point; the mesh's devices split
    into R contiguous groups of ``ndev / R``, each device decoding
    ``lanes * frames_per_lane / (ndev / R)`` frames of its point's frame-id
    space.  Counters are bit-identical to R serial
    ``mc_fano/mc_stack(code, lanes, frames_per_lane, seeds[r], params[r])``
    runs.  Returns (bit_errors[R], frame_errors[R], bits[R]) int64 arrays.
    """
    if decoder not in ("stack", "fano"):
        raise ValueError(f"not a sequential decoder: {decoder!r}")
    R = len(seeds)
    ndev = int(np.prod(list(mesh.shape.values())))
    if len(params) != R:
        raise ValueError("seeds/params length mismatch")
    if ndev % R:
        raise ValueError(f"{R} points do not divide {ndev} devices")
    dpp = ndev // R
    if lanes % dpp:
        raise ValueError(f"lanes {lanes} not divisible by {dpp} devices/point")
    Bl = lanes // dpp
    fc = frames_per_chunk(code, Bl, frames_per_lane, channel)
    step = _seq_grid_step(decoder, code, Bl, fc, channel, demapper,
                          int(timeout_per_bit) if decoder == "fano" else 0,
                          mesh)
    seed_dev = jnp.asarray(np.repeat(
        np.asarray([int(s) & 0x7FFFFFFF for s in seeds], np.int64),
        dpp).astype(np.int32))
    param_dev = jnp.asarray(np.repeat(np.asarray(params, np.float32), dpp))
    lane0_dev = jnp.asarray(np.tile(np.arange(dpp, dtype=np.int32) * Bl, R))
    outs = [step(seed_dev, param_dev, lane0_dev, jnp.int32(f0),
                 jnp.int32(frames_per_lane))
            for f0 in range(0, frames_per_lane, fc)]
    be = sum(np.asarray(b, np.int64) for b, _ in outs).reshape(R, dpp).sum(1)
    fe = sum(np.asarray(f, np.int64) for _, f in outs).reshape(R, dpp).sum(1)
    bits = np.full(R, lanes * frames_per_lane * code.block_length, np.int64)
    return be, fe, bits
