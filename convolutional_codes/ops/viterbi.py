"""Batched Viterbi decoders: vectorized add-compare-select + traceback.

Reference semantics (soft: ``AWGN-channel/viterbi-decoder.c``, hard:
``binary-symmetric-channel/viterbi-decoder.c``):
  * block decoding over ``T = block_len + K - 1`` symbols,
  * init: state 0 metric 0, all others +INF / 0xFF00 (decoder_reset),
  * ACS over all states x 2 inputs per symbol, strict-less compare so the
    smaller predecessor index wins ties (receive_symbol loops s ascending),
  * hard metrics are Hamming distances saturated at 0xFF00 (:127-130),
  * full-block traceback from the global-minimum end state (traceback();
    the reference does NOT force end state 0 despite tail termination).

Data layout:
  * metrics live as ``[S, B]`` with the batch minor.  The butterfly's
    predecessor pick and the branch-metric lookup are *static row
    permutations* of ``[S, B]`` / ``[2^m, B]`` arrays (the trellis is
    compile-time data), so one ACS step is a handful of fused elementwise
    adds/mins — no gathers at all.
  * decisions are bit-packed along the state axis into int32 words
    (``[T, ceil(S/32), B]``), 8x less device-memory traffic than byte
    decisions at K=7, and traceback needs no gather either: extracting the survivor bit
    for the current state is a per-lane variable shift, and the state
    recurrence ``prev = 2*(cur mod S/2) + bit`` is integer lane math.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from convolutional_codes.models.codebook import Code
from convolutional_codes.models.trellis import Trellis, build_trellis

#: Hard-decision metric saturation value (binary-symmetric-channel/
#: viterbi-decoder.c:127-130 and decoder_reset :222-232).
HARD_METRIC_SAT = 0xFF00


@functools.lru_cache(maxsize=None)
def _popcount_table(num_bits: int) -> np.ndarray:
    """[2^m, 2^m] int32: popcount(r ^ e) — Hamming branch-metric lookup."""
    n = 1 << num_bits
    r = np.arange(n)[:, None] ^ np.arange(n)[None, :]
    return np.array([[bin(x).count("1") for x in row] for row in r], dtype=np.int32)


def hard_branch_metrics(code: Code, received: jnp.ndarray) -> jnp.ndarray:
    """``[..., T]`` received symbols → ``[..., T, 2^m]`` Hamming distances
    to every possible expected symbol (int32)."""
    table = jnp.asarray(_popcount_table(code.symlen_out))
    return table[received]


def initial_metrics(trellis: Trellis, batch: int, hard: bool) -> jnp.ndarray:
    """State-0-pinned start metrics (decoder_reset: state 0 → 0, rest INF).
    Frame-major ``[B, S]`` (the public convention; transposed internally)."""
    S = trellis.num_states
    if hard:
        return jnp.full((batch, S), HARD_METRIC_SAT, jnp.int32).at[:, 0].set(0)
    return jnp.full((batch, S), jnp.inf, jnp.float32).at[:, 0].set(0.0)


def _packing(num_states: int) -> int:
    return (num_states + 31) // 32


def acs_forward(trellis: Trellis, branch_metrics: jnp.ndarray, hard: bool,
                init: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Forward ACS pass from arbitrary start metrics (streaming handoff uses
    non-default inits).  branch_metrics: [B, T, 2^m]; init: [B, S].

    Returns (final_metrics [B, S],
             decisions [T, ceil(S/32), B] int32 — bit s of word s//32 is the
             chosen-predecessor bit of new state s).
    """
    S = trellis.num_states
    nwords = _packing(S)
    dtype = jnp.int32 if hard else jnp.float32

    # static row-permutation tables
    prev0 = np.asarray(trellis.prev_state[:, 0])      # even predecessors, [S]
    prev1 = np.asarray(trellis.prev_state[:, 1])
    esym0 = np.asarray(trellis.esym_prev[:, 0])       # [S]
    esym1 = np.asarray(trellis.esym_prev[:, 1])
    # bit-packing: state s contributes bit (s % 32) of word s // 32
    pad_states = nwords * 32 - S
    bit_weight = jnp.asarray(
        (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, :, None])

    bm_tmb = jnp.swapaxes(branch_metrics.astype(dtype), 0, 1)   # [T, B, 2^m]
    bm_tmb = jnp.swapaxes(bm_tmb, 1, 2)                         # [T, 2^m, B]

    def step(metrics, bm_t):                                    # [S,B], [2^m,B]
        cand0 = metrics[prev0] + bm_t[esym0]                    # [S, B]
        cand1 = metrics[prev1] + bm_t[esym1]
        if hard:
            cand0 = jnp.minimum(cand0, HARD_METRIC_SAT)
            cand1 = jnp.minimum(cand1, HARD_METRIC_SAT)
        dec = cand1 < cand0                                     # strict: ties → 0
        new_metrics = jnp.where(dec, cand1, cand0)
        bits = dec.astype(jnp.uint32)                           # [S, B]
        if pad_states:
            bits = jnp.pad(bits, ((0, pad_states), (0, 0)))
        packed = (bits.reshape(nwords, 32, -1) * bit_weight).sum(axis=1,
                                                                 dtype=jnp.uint32)
        return new_metrics, packed.astype(jnp.int32)

    final_metrics, decisions = jax.lax.scan(step, init.T, bm_tmb)
    return final_metrics.T, decisions


def traceback_from(trellis: Trellis, decisions: jnp.ndarray,
                   start_states: jnp.ndarray,
                   start_index=None) -> jnp.ndarray:
    """Gather-free traceback from explicit per-frame start states.

    ``decisions``: packed [T, nwords, B]; ``start_states``: [B].  If
    ``start_index`` is given, steps with t >= start_index are no-ops (used
    by the streaming decoder).  Returns bits [B, T].
    """
    T = decisions.shape[0]
    S = trellis.num_states
    K = trellis.code.constraint_length
    half_mask = (S >> 1) - 1
    cur0 = start_states.astype(jnp.uint32)

    def tb_step(cur, xs):
        dec_t, t = xs                                  # [nwords, B], scalar
        nwords = decisions.shape[1]
        if nwords == 1:
            word = dec_t[0].astype(jnp.uint32)
        elif nwords <= 4:
            # static-row where-chain — no gather
            idx = (cur >> 5).astype(jnp.uint32)
            word = dec_t[0].astype(jnp.uint32)
            for w in range(1, nwords):
                word = jnp.where(idx == w, dec_t[w].astype(jnp.uint32), word)
        else:
            idx = (cur >> 5).astype(jnp.int32)         # word index per lane
            word = jnp.take_along_axis(
                dec_t.astype(jnp.uint32), idx[None, :], axis=0)[0]
        b = (word >> (cur & 31)) & 1
        bit = (cur >> (K - 2)).astype(jnp.int32)       # input into cur
        prev = ((cur & half_mask) << 1) | b
        if start_index is not None:
            prev = jnp.where(t < start_index, prev, cur)
        return prev, bit

    _, bits = jax.lax.scan(tb_step, cur0,
                           (decisions, np.arange(T, dtype=np.int32)),
                           reverse=True)
    return jnp.swapaxes(bits, 0, 1)


def _decode(trellis: Trellis, bm: jnp.ndarray, hard: bool
            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    B = bm.shape[0]
    final_metrics, decisions = acs_forward(
        trellis, bm, hard, initial_metrics(trellis, B, hard))
    end_state = jnp.argmin(final_metrics, axis=-1)     # first-wins ties
    min_metric = jnp.min(final_metrics, axis=-1)
    bits = traceback_from(trellis, decisions, end_state)
    return bits, min_metric


def viterbi_decode_soft(code: Code, distances: jnp.ndarray) -> jnp.ndarray:
    """Soft-decision block Viterbi.

    Args:
      distances: ``[B, T, 2^m]`` demapper distance vectors
        (T = block_len + K - 1).
    Returns:
      ``[B, block_len]`` decoded info bits (tail stripped).
    """
    trellis = build_trellis(code)
    bits, _ = _decode(trellis, distances.astype(jnp.float32), hard=False)
    return bits[:, : code.block_length].astype(jnp.int32)


def viterbi_decode_hard(code: Code, received: jnp.ndarray
                        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Hard-decision block Viterbi on received symbols.

    Args:
      received: ``[B, T]`` int symbols (already masked to symlen_out bits).
    Returns:
      (``[B, block_len]`` decoded bits, ``[B]`` winning path metric — the
      extra value the BSC callback carries,
      binary-symmetric-channel/include/decoder.h:9).
    """
    trellis = build_trellis(code)
    bm = hard_branch_metrics(code, received)
    bits, metric = _decode(trellis, bm, hard=True)
    return bits[:, : code.block_length].astype(jnp.int32), metric
