"""Streaming / long-frame Viterbi: time-block trellis partitioning.

The reference caps blocks at ~200 bits (uint8 lengths everywhere,
SURVEY.md §2d) and has no streaming mode.  This module decodes arbitrarily
long frames (e.g. the K=7 NASA-code config in BASELINE.json) by
partitioning the symbol stream into time blocks across a ``seq`` mesh axis
— the overlap-save scheme of parallel block-based Viterbi decoding:

  * each device receives its block plus a ``warmup``-symbol halo on both
    sides via ``ppermute`` neighbor exchange,
  * the left halo warms up the path metrics from a uniform start, so by the
    block's first real symbol they have converged to the monolithic
    decoder's metrics (up to a constant),
  * the right halo extends the trellis so the traceback has converged back
    onto the survivor path by the time it re-enters the block,
  * the first block instead starts exactly pinned to state 0 (its left halo
    branch metrics force the all-zero warmup path), and the last block
    starts its traceback at the true frame end.

With ``warmup`` ≳ 10 constraint lengths the result is bit-identical to a
monolithic decode with overwhelming probability (validated in tests);
boundary effects decay exponentially in the warmup length.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from convolutional_codes.models.codebook import Code
from convolutional_codes.models.trellis import build_trellis
from convolutional_codes.ops.viterbi import acs_forward, traceback_from

#: Large-but-finite soft metric for "impossible" warmup branches.  Using a
#: finite value keeps every state's metric ordered (inf would poison frames
#: whose halo is discarded anyway) while dominating any real path cost.
_PIN = 1e9


def _pin_first_block_halo(dists_halo: jnp.ndarray) -> jnp.ndarray:
    """Branch metrics that force the all-zero path: distance 0 for symbol 0,
    _PIN otherwise.  After K-1 such steps the metric vector equals the
    state-0-pinned initial metrics up to paths costing >= _PIN."""
    out = jnp.full_like(dists_halo, _PIN)
    return out.at[..., 0].set(0.0)


def streaming_viterbi_decode(code: Code, dists: jnp.ndarray, mesh: Mesh,
                             warmup: int = 128, seq_axis: str = "seq"
                             ) -> jnp.ndarray:
    """Decode a long soft-demapped frame sharded over time blocks.

    Args:
      dists: ``[B, T, 2^m]`` distance stream, T divisible by the seq-axis
        size; sharded (or shardable) over axis 1.
      mesh: mesh containing ``seq_axis``.
      warmup: halo length W in symbols.

    Returns: ``[B, T]`` decoded bits (the caller strips the K-1 tail).
    """
    D = mesh.shape[seq_axis]
    B, T, M = dists.shape
    if T % D != 0:
        raise ValueError(f"frame length {T} not divisible by seq axis {D}")
    return _streaming_fn(code, mesh, warmup, seq_axis)(dists)


@lru_cache(maxsize=None)
def _streaming_fn(code: Code, mesh: Mesh, W: int, seq_axis: str):
    """Cached jitted shard_map runner — a fresh closure per call would
    recompile every decode."""
    trellis = build_trellis(code)
    D = mesh.shape[seq_axis]

    spec_in = P(None, seq_axis, None)
    spec_out = P(None, seq_axis)

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(spec_in,), out_specs=spec_out,
             check_vma=False)
    def run(local):                                   # [B, Tl, M]
        B, Tl = local.shape[:2]
        idx = jax.lax.axis_index(seq_axis)
        # halo exchange over the ring
        right_edge = local[:, Tl - W:]                # sent rightward
        left_edge = local[:, :W]                      # sent leftward
        from_left = jax.lax.ppermute(
            right_edge, seq_axis, [(i, (i + 1) % D) for i in range(D)])
        from_right = jax.lax.ppermute(
            left_edge, seq_axis, [(i, (i - 1) % D) for i in range(D)])
        first = idx == 0
        last = idx == D - 1
        left_halo = jnp.where(first, _pin_first_block_halo(from_left), from_left)
        ext = jnp.concatenate([left_halo, local, from_right], axis=1)

        # Forward ACS over [W | Tl | W]; capture metrics at the true frame
        # end for the last block's traceback.
        init = jnp.zeros((B, trellis.num_states), jnp.float32)
        mid_m, dec_a = acs_forward(trellis, ext[:, : W + Tl], False, init)
        end_m, dec_b = acs_forward(trellis, ext[:, W + Tl:], False, mid_m)
        decisions = jnp.concatenate([dec_a, dec_b], axis=0)
        mid_am = jnp.argmin(mid_m, axis=-1)
        end_am = jnp.argmin(end_m, axis=-1)

        start_state = jnp.where(last, mid_am, end_am).astype(jnp.int32)
        start_index = jnp.where(last, W + Tl, W + Tl + W)
        bits_ext = traceback_from(trellis, decisions, start_state,
                                  start_index=start_index)
        return bits_ext[:, W: W + Tl]

    return run


def monolithic_reference_decode(code: Code, dists: jnp.ndarray) -> jnp.ndarray:
    """Single-program long-frame decode (ground truth for boundary checks)."""
    trellis = build_trellis(code)
    B = dists.shape[0]
    init = jnp.full((B, trellis.num_states), jnp.inf, jnp.float32).at[:, 0].set(0.0)
    final_metrics, decisions = acs_forward(trellis, dists.astype(jnp.float32),
                                           False, init)
    bits = traceback_from(trellis, decisions,
                          jnp.argmin(final_metrics, axis=-1).astype(jnp.int32))
    return bits


@lru_cache(maxsize=None)
def _fused_stream_runner(code: Code, lanes: int, wpd: int, window: int,
                         warmup: int, channel: str, demapper: str,
                         mesh: Mesh, interpret: bool):
    from convolutional_codes.ops.viterbi_mc import mc_longframe_viterbi

    axes = tuple(mesh.axis_names)

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(), P(), P(axes)),
             out_specs=(P(), P()), check_vma=False)
    def run(seed, param, win0):
        be, we = mc_longframe_viterbi(
            code, lanes, wpd, seed, param, channel=channel,
            demapper=demapper, window=window, warmup=warmup, win0=win0,
            interpret=interpret)
        return (jax.lax.psum(be, axes), jax.lax.psum(we, axes))

    return run


# the fused kernel embeds the constellation tables of code.symlen_out
from convolutional_codes.models.constellations import (  # noqa: E402
    register_dependent_cache as _reg_dep)

_reg_dep(_fused_stream_runner.cache_clear)


def streaming_mc_accumulate(code: Code, lanes: int, windows: int, seed,
                            param, mesh: Mesh, channel: str = "awgn",
                            demapper: str = "soft", window: int = 1920,
                            warmup: int = 128, interpret: bool = False):
    """Sequence-parallel fused streaming Monte-Carlo: each device decodes a
    distinct TIME RANGE of the same ``lanes`` coded streams.

    The fused long-frame kernel's windows are independent overlap-save
    decodes of hash-addressed stream positions (ops/viterbi_mc), so
    sequence parallelism needs no ppermute state handoff: each device
    regenerates its halos locally from the position-addressable RNG, and a
    D-device run is **bit-identical** to the monolithic
    ``mc_longframe_viterbi(code, lanes, windows, ...)`` decode of the same
    streams (tests/test_streaming.py).  The distance-fed handoff path
    above remains for decoding real received data.  There are no
    collectives on the hot path; one psum per call.

    Returns (bit_errors [lanes], window_errors [lanes], info_bits) with
    counters summed across devices.
    """
    ndev = int(np.prod(list(mesh.shape.values())))
    if windows % ndev:
        raise ValueError(f"{windows} windows not divisible by {ndev} devices")
    wpd = windows // ndev
    run = _fused_stream_runner(code, lanes, wpd, window, warmup, channel,
                               demapper, mesh, interpret)
    win0 = jnp.asarray(np.arange(ndev, dtype=np.int32) * wpd)
    be, we = run(jnp.int32(int(seed) & 0x7FFFFFFF), jnp.float32(param), win0)
    return be, we, lanes * windows * window


def dryrun_streaming(n_devices: int, interpret: bool = False) -> None:
    """Tiny end-to-end streaming step over a ``seq`` mesh (multi-device dry run)."""
    from convolutional_codes.models.codebook import get_code
    from convolutional_codes.ops.encoder import encode_stream
    from convolutional_codes.parallel.mesh import make_mesh

    code = get_code("nasa-k7")
    mesh = make_mesh({"seq": n_devices}, devices=jax.devices()[:n_devices])
    W = 16
    L = n_devices * 64 - (code.constraint_length - 1)
    key = jax.random.PRNGKey(0)
    bits = jax.random.bernoulli(key, 0.5, (2, L)).astype(jnp.int32)
    syms = encode_stream(code, bits, terminate=True)
    M = code.points_per_symbol
    dists = jnp.ones(syms.shape + (M,), jnp.float32)
    onehot = jax.nn.one_hot(syms, M, dtype=jnp.float32)
    dists = dists - onehot  # 0 at tx symbol, 1 elsewhere (noiseless)
    out = streaming_viterbi_decode(code, dists, mesh, warmup=W)
    decoded = np.asarray(out)[:, :L]
    assert np.array_equal(decoded, np.asarray(bits)), "streaming dryrun mismatch"

    # fused streaming MC leg: per-device time-range windows, psum counters
    be, we, nb = streaming_mc_accumulate(
        code, lanes=8, windows=n_devices, seed=3, param=0.35, mesh=mesh,
        window=64, warmup=32, interpret=interpret)
    assert nb == 8 * n_devices * 64
    assert be.shape == (8,)
