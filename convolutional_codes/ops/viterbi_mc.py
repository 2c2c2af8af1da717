"""Fused Viterbi Monte-Carlo kernel (Pallas through Triton).

One kernel runs whole Monte-Carlo steps of the Viterbi chain per frame
lane: info bits, shift-register encoding, the channel (Box-Muller AWGN or
per-coded-bit BSC flips), demapping, add-compare-select with bit-packed
decisions, traceback and error counting.  The only device-memory traffic
is the packed decision words, written once and read back once by the
traceback (they stay in L2 at production batch), and the per-lane error
counters.  The XLA chain it replaces
writes the random bits, ``[B, T, M]`` float32 distances and the packed
decisions to device memory and launches a 2T-step scan; removing that
round trip is the kernel's whole purpose.

Layout: one frame per lane, a block of ``BLOCK_LANES`` lanes per program,
and a loop over ``nsteps`` Monte-Carlo steps inside the program.  Path
metrics live in registers as ``S`` separate ``(Bt,)`` rows, so every
trellis permutation is a static choice of rows.  Random numbers are the
coordinate hash of ops/coord_hash addressed by (frame id, position), so
the traceback regenerates the info bits instead of storing them, and
:func:`replica_counts` rebuilds the identical frames with plain XLA.

Two frame structures share the kernel:

  * terminated blocks (the reference chains, AWGN-channel/main.c:80-144 and
    binary-symmetric-channel/main.c:57-98): frame id ``lane * nsteps +
    step``, positions ``0..T-1``, state-0 start, errors over the ``L``
    info bits;
  * overlap-save windows of unterminated per-lane streams (``window``
    payload symbols with ``warmup`` halos on both sides): the lane id
    addresses the stream, window ``step`` covers positions ``(win0 + step)
    * window - warmup`` onward, metrics start uniform, errors count over
    the payload only.  Windows are independent decodes of hash-addressed
    positions, so a device mesh can split a stream by time range
    (parallel/streaming.streaming_mc_accumulate) bit-identically.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from convolutional_codes.models.codebook import Code
from convolutional_codes.models.constellations import register_dependent_cache
from convolutional_codes.models.trellis import build_trellis
from convolutional_codes.ops.coord_hash import coord_bits
from convolutional_codes.ops.mc_datagen import channel_fns, frames_host, stage_fns
from convolutional_codes.ops.viterbi import (
    HARD_METRIC_SAT, acs_forward, traceback_from, viterbi_decode_hard,
    viterbi_decode_soft)

#: Largest trellis the kernel takes (K <= 7).  Every state's metric is a
#: register row, so register pressure grows with S.
MAX_STATES = 64

#: Frames per program (one per thread at ``_NUM_WARPS`` warps).
BLOCK_LANES = 128
_NUM_WARPS = 4


def eligible(code: Code) -> bool:
    return (code.num_states <= MAX_STATES
            and code.points_per_symbol <= 8)


def _kernel(code: Code, T: int, L: int, Bt: int, channel: str,
            demapper: str, window: Optional[int], warmup: int):
    trellis = build_trellis(code)
    S = trellis.num_states
    K = code.constraint_length
    nwords = (S + 31) // 32
    half_mask = np.uint32((S >> 1) - 1)
    prev0 = [int(x) for x in trellis.prev_state[:, 0]]
    prev1 = [int(x) for x in trellis.prev_state[:, 1]]
    esym0 = [int(x) for x in trellis.esym_prev[:, 0]]
    esym1 = [int(x) for x in trellis.esym_prev[:, 1]]
    esym_of = stage_fns(code)[0]
    chan = channel_fns(code, channel, demapper)
    hard = channel == "bsc"
    stream = window is not None
    sat = float(HARD_METRIC_SAT)

    def acs(mets, dvec):
        """compare-select with packed decisions (ties → branch 0 by the
        strict-less compare — do not 'simplify' to argmin)."""
        new, decs = [], []
        for s in range(S):
            c0 = mets[prev0[s]] + dvec[esym0[s]]
            c1 = mets[prev1[s]] + dvec[esym1[s]]
            if hard:
                c0 = jnp.minimum(c0, sat)
                c1 = jnp.minimum(c1, sat)
            d = c1 < c0
            new.append(jnp.where(d, c1, c0))
            decs.append(d.astype(jnp.uint32))
        words = []
        for w in range(nwords):
            acc = decs[32 * w]
            for s in range(32 * w + 1, min(32 * w + 32, S)):
                acc = acc | (decs[s] << (s - 32 * w))
            words.append(acc)
        return new, words

    def kernel(seed_ref, param_ref, nsteps_ref, win0_ref, err_ref, dec_ref):
        seed = seed_ref[0]
        param = param_ref[0]
        nsteps = nsteps_ref[0]
        lane = (pl.program_id(0) * Bt
                + jax.lax.broadcasted_iota(jnp.int32, (Bt,), 0))
        zero_u = jnp.zeros((Bt,), jnp.uint32)
        zero_i = jnp.zeros((Bt,), jnp.int32)

        def info_bit(ident, pos, t):
            b = coord_bits(ident, pos, seed, 0) & np.uint32(1)
            return b if stream else jnp.where(t < L, b, np.uint32(0))

        def counted(t):
            if stream:
                return (t >= warmup) & (t < warmup + window)
            return t < L

        def one_step(step, carry):
            errs, ferrs = carry
            if stream:
                ident = lane
                base = (win0_ref[0] + step) * window - warmup
            else:
                ident = lane * nsteps + step
                base = jnp.int32(0)
            reg = zero_u
            if stream:
                # the K-1 bits before the window seed the encoder register
                for j in range(K - 1):
                    b = info_bit(ident, base - (K - 1) + j, None)
                    reg = (reg >> 1) | (b << (K - 1))
                mets = [jnp.zeros((Bt,), jnp.float32)] * S
            else:
                far = sat if hard else jnp.inf
                mets = ([jnp.zeros((Bt,), jnp.float32)]
                        + [jnp.full((Bt,), far, jnp.float32)] * (S - 1))

            def fwd(t, c):
                mets, reg = c
                pos = base + t
                reg = (reg >> 1) | (info_bit(ident, pos, t) << (K - 1))
                dvec, _ = chan(esym_of(reg), ident, pos, seed, param)
                mets, words = acs(mets, dvec)
                for w in range(nwords):
                    dec_ref[0, t * nwords + w, :] = words[w].astype(jnp.int32)
                return tuple(mets), reg

            mets, _ = jax.lax.fori_loop(0, T, fwd, (tuple(mets), reg))

            # end state: first minimum (strict less → lowest state wins)
            best, cur = mets[0], zero_u
            for s in range(1, S):
                better = mets[s] < best
                best = jnp.where(better, mets[s], best)
                cur = jnp.where(better, np.uint32(s), cur)

            def tb(i, c):
                cur, err, fe = c
                t = T - 1 - i
                word = dec_ref[0, t * nwords, :].astype(jnp.uint32)
                for w in range(1, nwords):
                    word = jnp.where(
                        (cur >> 5) == w,
                        dec_ref[0, t * nwords + w, :].astype(jnp.uint32),
                        word)
                b = (word >> (cur & np.uint32(31))) & np.uint32(1)
                bit = cur >> (K - 2)
                mism = ((bit != info_bit(ident, base + t, t))
                        & counted(t)).astype(jnp.int32)
                cur = ((cur & half_mask) << 1) | b
                return cur, err + mism, fe | mism

            _, err, fe = jax.lax.fori_loop(0, T, tb, (cur, zero_i, zero_i))
            return errs + err, ferrs + fe

        # dynamic trip count: one executable serves every sample tier
        errs, ferrs = jax.lax.fori_loop(0, nsteps, one_step, (zero_i, zero_i))
        err_ref[0, :] = errs
        err_ref[1, :] = ferrs

    return kernel, T * nwords


def _scalar(x, dtype):
    return jnp.asarray(x, dtype).reshape((1,))


@functools.lru_cache(maxsize=None)
def _call(code: Code, B: int, Bt: int, channel: str, demapper: str,
          window: Optional[int], warmup: int, interpret: bool):
    T = code.num_block_symbols if window is None else window + 2 * warmup
    kernel, dec_rows = _kernel(code, T, code.block_length, Bt, channel,
                               demapper, window, warmup)
    nprog = B // Bt
    return pl.pallas_call(
        kernel,
        grid=(nprog,),
        in_specs=[pl.BlockSpec((1,), lambda i: (0,))] * 4,
        # the second output is each program's decision rows, written by the
        # forward loop and read back by the traceback (scratch)
        out_specs=[pl.BlockSpec((2, Bt), lambda i: (0, i)),
                   pl.BlockSpec((1, dec_rows, Bt), lambda i: (i, 0, 0))],
        out_shape=[jax.ShapeDtypeStruct((2, B), jnp.int32),
                   jax.ShapeDtypeStruct((nprog, dec_rows, Bt), jnp.int32)],
        interpret=interpret,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
        name="viterbi_mc",
    )


# the kernel embeds the constellation table of code.symlen_out
register_dependent_cache(_call.cache_clear)


def _run(code, B, nsteps, seed, param, channel, demapper, window, warmup,
         win0, interpret, block_lanes):
    if not eligible(code):
        raise ValueError(f"{code.name}: the Viterbi MC kernel takes at most "
                         f"{MAX_STATES} states and 8 constellation points")
    if channel not in ("awgn", "bsc"):
        raise ValueError(f"channel must be awgn or bsc, got {channel!r}")
    if interpret and jax.devices()[0].platform == "gpu":
        raise ValueError("interpret mode is for the CPU tests; the GPU runs "
                         "the compiled kernel")
    Bt = min(block_lanes, B)
    if Bt & (Bt - 1) or B % Bt:
        raise ValueError(f"batch {B} must be a multiple of a power-of-two "
                         f"tile (got tile {Bt})")
    call = _call(code, B, Bt, channel, demapper, window, warmup, interpret)
    out = call(_scalar(seed, jnp.int32), _scalar(param, jnp.float32),
               _scalar(nsteps, jnp.int32), _scalar(win0, jnp.int32))
    return out[0][0], out[0][1]


def mc_chain_viterbi(code: Code, batch: int, nsteps, seed, param,
                     channel: str = "awgn", demapper: str = "soft",
                     interpret: bool = False,
                     block_lanes: int = BLOCK_LANES
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run ``nsteps`` whole Monte-Carlo steps of the Viterbi chain over
    ``batch`` frame lanes.  ``channel``: "awgn" (param = sigma) or "bsc"
    (param = crossover probability, saturating Hamming metrics).
    Returns per-lane (bit_errors [B], frame_errors [B]) int32; simulated
    info bits = batch * nsteps * block_length."""
    return _run(code, batch, nsteps, seed, param, channel, demapper, None, 0,
                0, interpret, block_lanes)


def mc_longframe_viterbi(code: Code, lanes: int, nsteps, seed, param,
                         channel: str = "awgn", demapper: str = "soft",
                         window: int = 1920, warmup: int = 128, win0=0,
                         interpret: bool = False,
                         block_lanes: int = BLOCK_LANES
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Monte-Carlo long-frame Viterbi chain: each of ``lanes`` independent
    unterminated coded streams advances ``nsteps`` windows of ``window``
    payload symbols with ``warmup`` halos.  ``win0`` offsets the window
    index (a device's time range under sequence sharding).  Returns
    per-lane (bit_errors, window_errors) int32; simulated info bits =
    ``lanes * nsteps * window``."""
    if channel == "bsc" and 2 * (window + 2 * warmup) >= HARD_METRIC_SAT:
        raise ValueError(f"window+halos {window + 2 * warmup} too long for "
                         "saturating hard metrics (ceiling 0xFF00)")
    return _run(code, lanes, nsteps, seed, param, channel, demapper, window,
                warmup, win0, interpret, block_lanes)


# ---------------------------------------------------------------------------
# Plain XLA replicas of the same frames (validation and timing reference)
# ---------------------------------------------------------------------------

def replica_counts(code: Code, batch: int, nsteps: int, seed: int, param,
                   channel: str = "awgn", demapper: str = "soft"):
    """Per-lane (bit_errors, frame_errors) of the frames
    :func:`mc_chain_viterbi` simulates, rebuilt with ops/mc_datagen and
    decoded by the XLA ``viterbi_decode_*``."""
    L = code.block_length
    gids = (np.arange(batch)[:, None] * nsteps
            + np.arange(nsteps)[None, :]).reshape(-1)
    bits, syms = frames_host(code, gids, seed, param, channel, demapper)
    if channel == "awgn":
        dec = viterbi_decode_soft(code, jnp.asarray(syms))
    else:
        dec, _ = viterbi_decode_hard(code, jnp.asarray(syms))
    err = (np.asarray(dec) != bits[:, :L]).reshape(batch, nsteps, L)
    return err.sum(axis=(1, 2)), err.any(axis=2).sum(axis=1)


def stream_segment_host(code: Code, lane_ids: np.ndarray, seed,
                        param: float, channel: str, start: int, length: int,
                        demapper: str = "soft"):
    """Rebuild the (bits, branch-metric) stream segment
    :func:`mc_longframe_viterbi` simulates for the given lanes, positions
    ``start .. start+length-1``, with plain jnp ops.  Returns (bits [B,
    length], dists [B, length, 2^m])."""
    K = code.constraint_length
    esym_of = stage_fns(code)[0]
    chan = channel_fns(code, channel, demapper)
    lanes = jnp.asarray(lane_ids, jnp.int32)[:, None]
    pos = jnp.arange(start - (K - 1), start + length)[None, :]
    seed_a = jnp.asarray(seed).astype(jnp.uint32)

    bits = (coord_bits(lanes, pos, seed_a, 0) & 1).astype(jnp.int32)
    # reg[t] = sum_j bits[t + K-1 - j] << (K-1-j)  (newest bit at K-1)
    barr = bits.astype(jnp.uint32)
    reg = jnp.zeros((barr.shape[0], length), jnp.uint32)
    for j in range(K):
        reg = reg | (barr[:, K - 1 - j: K - 1 - j + length] << (K - 1 - j))
    dvec, _ = chan(esym_of(reg), lanes, pos[:, K - 1:], seed_a,
                   jnp.asarray(param, jnp.float32))
    return bits[:, K - 1:], jnp.stack(dvec, axis=-1)


@functools.lru_cache(maxsize=None)
def window_replica(code: Code, lanes: int, channel: str, demapper: str,
                   window: int, warmup: int, step: int):
    """Jitted ``(seed, param) -> per-lane bit errors`` of window ``step``
    of :func:`mc_longframe_viterbi`'s streams, decoded with the XLA ACS and
    traceback (soft ACS on the hard distances: equal to the saturating form
    while metrics stay below 0xFF00, which the kernel entry checks)."""
    trellis = build_trellis(code)
    Tw = window + 2 * warmup

    @jax.jit
    def run(seed, param):
        bits, dists = stream_segment_host(
            code, np.arange(lanes), seed, param, channel,
            start=step * window - warmup, length=Tw, demapper=demapper)
        init = jnp.zeros((lanes, trellis.num_states), jnp.float32)
        fm, decs = acs_forward(trellis, dists, False, init)
        out = traceback_from(trellis, decs,
                             jnp.argmin(fm, axis=-1).astype(jnp.int32))
        pay = slice(warmup, warmup + window)
        return jnp.sum(out[:, pay] != bits[:, pay], axis=1)

    return run


register_dependent_cache(window_replica.cache_clear)


def longframe_replica_counts(code: Code, lanes: int, nsteps: int, seed: int,
                             param, channel: str = "awgn",
                             demapper: str = "soft", window: int = 1920,
                             warmup: int = 128):
    """Per-lane bit errors of :func:`mc_longframe_viterbi`'s windows,
    decoded window by window by :func:`window_replica`."""
    return sum(np.asarray(window_replica(code, lanes, channel, demapper,
                                         window, warmup, step)(
                   jnp.int32(seed), jnp.float32(param)), np.int64)
               for step in range(nsteps))
