"""Batched ZJ/stack sequential decoder as masked fixed-shape search.

Reference semantics (soft: ``AWGN-channel/stack-decoder.c``, hard:
``binary-symmetric-channel/stack-decoder.c``):
  * fixed capacity of 64 paths (STACK_DEPTH, :12); below capacity new paths
    append, at capacity the least-probable path is overwritten (:227-241),
  * per received symbol: repeatedly extend the most-probable path (strict-
    greater linear scan → first max wins, :213-225) by both inputs — the
    original path takes input 0, the duplicate input 1 (:138-171),
  * a path stops being extendable once it has consumed every symbol received
    so far; when the best path has consumed the whole block it is emitted,
  * soft branch metric ``1 + metric_weight * dist[esym]`` (:274), hard
    ``hamming*wrong + (symlen-hamming)*correct`` (BSC :267-272).

Decoded paths are bit-packed into uint32 words ([batch, 64, ceil(T/32)]) —
the path store is the decoder's memory-bandwidth hot spot, and packing cuts
the per-extension duplicate-copy traffic 8x vs byte-per-bit storage.

Lockstep formulation (the XLA reference; the GPU path walks one frame
per thread in native/seq_decode.cu): all frames advance in lockstep inside one
``lax.while_loop``.  Per iteration each frame performs exactly one reference
loop step — either "accept next symbol" (best path caught up) or "extend
best path" — so the per-frame serialization is bit-identical to the C
decoder while the work vectorizes over ``[batch, 64]`` lanes.
Encoder states are uint32 (covers K <= 32, including WSPR's 31-bit states).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from convolutional_codes.models.codebook import Code
from convolutional_codes.ops.sequential_common import (
    make_branch_fn, soft_transition_metrics, hard_transition_metrics)

STACK_DEPTH = 64

# numpy scalars: device-committed constants at import time would touch the
# backend on `import convolutional_codes` (and hang if it is down)
_NEG = np.float32(-np.inf)
_POS = np.float32(np.inf)
_INEG = np.int32(-2**31 + 1)
_IPOS = np.int32(2**31 - 1)


def _stack_decode(code: Code, symbols: jnp.ndarray, soft: bool,
                  max_iters: Optional[int] = None,
                  unroll: int = 4) -> jnp.ndarray:
    """symbols: [B, T, 2^m] float32 distances (soft) or [B, T] int (hard)."""
    B = symbols.shape[0]
    T = code.num_block_symbols
    branch = make_branch_fn(code)
    arangeB = jnp.arange(B)

    if soft:
        mdtype, neg, pos = jnp.float32, _NEG, _POS
    else:
        mdtype, neg, pos = jnp.int32, _INEG, _IPOS

    nwords = (T + 31) // 32
    # Path arrays. Like the reference, only slots < nstack are live.
    nii = jnp.zeros((B, STACK_DEPTH), jnp.int32)        # next symbol index
    state = jnp.zeros((B, STACK_DEPTH), jnp.uint32)
    metric = jnp.zeros((B, STACK_DEPTH), mdtype)
    bits = jnp.zeros((B, STACK_DEPTH, nwords), jnp.uint32)  # packed paths
    nstack = jnp.ones((B,), jnp.int32)
    widx = jnp.ones((B,), jnp.int32)                    # symbols received
    done = jnp.zeros((B,), bool)

    slot = jnp.arange(STACK_DEPTH)[None, :]

    def best_path(metric, nstack):
        live = slot < nstack[:, None]
        return jnp.argmax(jnp.where(live, metric, neg), axis=1).astype(jnp.int32)

    def worst_path(metric, nstack):
        live = slot < nstack[:, None]
        return jnp.argmin(jnp.where(live, metric, pos), axis=1).astype(jnp.int32)

    def cond(carry):
        done = carry[-1]
        return ~jnp.all(done)

    def body(carry):
        nii, state, metric, bits, nstack, widx, done = carry
        cur = best_path(metric, nstack)
        cur_nii = nii[arangeB, cur]
        caught = cur_nii == widx

        # --- accept-next-symbol action (caught frames) --------------------
        finished = caught & (widx == T)
        advance = caught & (widx < T) & ~done
        widx = jnp.where(advance, widx + 1, widx)
        done = done | finished

        # --- extension action (not caught, not done) ----------------------
        ext = ~caught & ~done
        s = state[arangeB, cur]
        m = metric[arangeB, cur]
        t = jnp.clip(cur_nii, 0, T - 1)
        ns0, e0 = branch(s, 0)
        ns1, e1 = branch(s, 1)
        if soft:
            row = jnp.take_along_axis(
                symbols, t[:, None, None], axis=1)[:, 0]          # [B, 2^m]
            tm0, tm1 = soft_transition_metrics(code.metric_weight, row, e0, e1)
        else:
            rx = jnp.take_along_axis(symbols, t[:, None], axis=1)[:, 0]
            tm0, tm1 = hard_transition_metrics(code.bit_metrics,
                                               code.symlen_out, rx, e0, e1)

        at_cap = nstack >= STACK_DEPTH
        new = jnp.where(at_cap, worst_path(metric, nstack), nstack).astype(jnp.int32)
        # masked frames scatter to their current slot with unchanged values
        new = jnp.where(ext, new, cur)

        cur_row = bits[arangeB, cur]                            # [B, nwords]
        # set bit t (per-frame word index / bit position) in the duplicate
        word_onehot = (jnp.arange(nwords)[None, :] == (t[:, None] >> 5))
        setbit = ((jnp.uint32(1) << (t[:, None] & 31).astype(jnp.uint32))
                  * word_onehot.astype(jnp.uint32))

        # duplicate (input 1) — from the *original* path fields
        nii = nii.at[arangeB, new].set(jnp.where(ext, cur_nii + 1, nii[arangeB, new]))
        state = state.at[arangeB, new].set(jnp.where(ext, ns1, state[arangeB, new]))
        metric = metric.at[arangeB, new].set(
            jnp.where(ext, (m + tm1).astype(mdtype), metric[arangeB, new]))
        row1 = cur_row | setbit
        bits = bits.at[arangeB, new].set(
            jnp.where(ext[:, None], row1, bits[arangeB, new]))

        # original path takes input 0 (bit at t stays 0 — see the induction
        # note: positions >= nii are always 0 in live paths)
        nii = nii.at[arangeB, cur].set(jnp.where(ext, cur_nii + 1, nii[arangeB, cur]))
        state = state.at[arangeB, cur].set(jnp.where(ext, ns0, state[arangeB, cur]))
        metric = metric.at[arangeB, cur].set(
            jnp.where(ext, (m + tm0).astype(mdtype), metric[arangeB, cur]))

        nstack = jnp.where(ext & ~at_cap, nstack + 1, nstack)
        return nii, state, metric, bits, nstack, widx, done

    def body_n(carry):
        # every update is masked per frame, so running extra iterations past
        # a frame's completion is a no-op — unrolling amortizes while-loop
        # overhead and lets XLA fuse across micro-steps
        for _ in range(unroll):
            carry = body(carry)
        return carry

    carry = (nii, state, metric, bits, nstack, widx, done)
    if max_iters is None:
        carry = jax.lax.while_loop(cond, body_n, carry)
    else:
        def fori_body(_, c):
            return jax.lax.cond(cond(c), body_n, lambda x: x, c)
        carry = jax.lax.fori_loop(0, max_iters, fori_body, carry)
    nii, state, metric, bits, nstack, widx, done = carry
    cur = best_path(metric, nstack)
    packed = bits[arangeB, cur]                                 # [B, nwords]
    t_idx = jnp.arange(code.block_length)
    unpacked = (packed[:, t_idx >> 5] >> (t_idx & 31)[None, :]) & 1
    win_metric = metric[arangeB, cur]
    return unpacked.astype(jnp.int32), win_metric


@partial(jax.jit, static_argnums=(0,))
def stack_decode_soft(code: Code, distances: jnp.ndarray) -> jnp.ndarray:
    """``[B, T, 2^m]`` demapper distances → ``[B, block_len]`` decoded bits."""
    bits, _ = _stack_decode(code, distances.astype(jnp.float32), soft=True)
    return bits


@partial(jax.jit, static_argnums=(0,))
def stack_decode_hard(code: Code, received: jnp.ndarray) -> jnp.ndarray:
    """``[B, T]`` received symbols → ``[B, block_len]`` decoded bits."""
    bits, _ = _stack_decode(code, received.astype(jnp.int32), soft=False)
    return bits


@partial(jax.jit, static_argnums=(0,))
def stack_decode_hard_with_metric(code: Code, received: jnp.ndarray):
    """Hard stack decode also returning the winning path metric (the value
    the reference's BSC callback carries,
    binary-symmetric-channel/include/decoder.h:9)."""
    return _stack_decode(code, received.astype(jnp.int32), soft=False)
