"""Batched Fano sequential decoder as a lockstep masked register machine.

Reference semantics (soft: ``AWGN-channel/fano-decoder.c``, hard:
``binary-symmetric-channel/fano-decoder.c``; both derived from the public
KA9Q Fano decoder):
  * single path with running threshold T, step DELTA=17 (:15), per-block
    budget of TIMEOUT=10000 cycles per decoded bit (:14, armed in
    decoder_reset),
  * per node: both branch metrics/successors computed and sorted best-first;
    ``decoded_input`` flips whenever the other branch is selected (:169-181),
  * forward move when the best unexplored successor metric >= T, with
    threshold tightening when the node was first reached (:189-236);
    otherwise back up while the predecessor still satisfies T, else relax T
    by delta and retry from the best branch (:237-264),
  * on budget exhaustion the best-so-far decoded bits are emitted and the
    rest of the block is ignored (:267-272) — nodes beyond the deepest visit
    keep decoded_input = 0.

Lockstep formulation (the XLA reference; the GPU path walks one frame
per thread in native/seq_decode.cu): every frame advances through an identical micro-step
machine inside one ``lax.while_loop``.  A SEARCH micro-step performs one
reference outer-loop iteration head (timeout decrement, successor-metric
test, forward move incl. tightening, or a switch into BACKTRACK); each
BACKTRACK micro-step performs one iteration of the reference's inner
back-up loop (which costs no timeout in the reference either).  The
serialization per frame is bit-identical to the C decoder; across frames
everything is masked vector lanes.  The whole block's symbols are buffered
up front — equivalent to the reference's streaming intake because the walk
only ever pauses at the frontier, where the reference immediately resumes
on the next symbol (validated empirically via the golden model).

The threshold-tightening inner loop (``while ms >= T+d: T += d``) is
replaced by a closed-form division with two rounding-correction steps —
exact because thresholds stay integer multiples of delta.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from convolutional_codes.models.codebook import Code
from convolutional_codes.ops.sequential_common import (
    make_branch_fn, soft_transition_metrics, hard_transition_metrics)

FANO_TIMEOUT = 10000   # cycles per decoded bit (fano-decoder.c:14)
FANO_DELTA = 17.0      # threshold step (fano-decoder.c:15)

_SEARCH = np.int8(0)      # numpy: no device touch at import time
_BACKTRACK = np.int8(1)


def _fano_parts(code: Code, symbols: jnp.ndarray, soft: bool,
                timeout_per_bit: int, unroll: int = 4):
    """Build (initial carry, cond, unrolled body) for the fano machine."""
    B = symbols.shape[0]
    T = code.num_block_symbols
    branch = make_branch_fn(code)
    arangeB = jnp.arange(B)

    if soft:
        mdtype = jnp.float32
        delta = jnp.float32(FANO_DELTA)
    else:
        mdtype = jnp.int32
        delta = jnp.int32(int(FANO_DELTA))

    def node_metrics(s, t):
        """Sorted branch data for nodes at per-frame symbol index t (state s)."""
        ns0, e0 = branch(s, 0)
        ns1, e1 = branch(s, 1)
        if soft:
            row = jnp.take_along_axis(symbols, t[:, None, None], axis=1)[:, 0]
            tm0, tm1 = soft_transition_metrics(code.fano_metric_weight, row, e0, e1)
        else:
            rx = jnp.take_along_axis(symbols, t[:, None], axis=1)[:, 0]
            tm0, tm1 = hard_transition_metrics(code.fano_bit_metrics,
                                               code.symlen_out, rx, e0, e1)
        swap = tm0 < tm1          # strict: sorted best-first, ties keep input 0
        btm0 = jnp.where(swap, tm1, tm0).astype(mdtype)
        btm1 = jnp.where(swap, tm0, tm1).astype(mdtype)
        bs0 = jnp.where(swap, ns1, ns0)
        bs1 = jnp.where(swap, ns0, ns1)
        return bs0, bs1, btm0, btm1, swap.astype(jnp.int8)

    # node arrays
    nstate = jnp.zeros((B, T), jnp.uint32)
    nmetric = jnp.zeros((B, T), mdtype)
    succ0 = jnp.zeros((B, T), jnp.uint32)
    succ1 = jnp.zeros((B, T), jnp.uint32)
    tm0 = jnp.zeros((B, T), mdtype)
    tm1 = jnp.zeros((B, T), mdtype)
    selected = jnp.zeros((B, T), jnp.int8)
    decoded = jnp.zeros((B, T), jnp.int8)

    # initialize node 0 (state 0) — the first receive_symbol's metric compute
    z = jnp.zeros((B,), jnp.int32)
    s0, s1, t0, t1, dec0 = node_metrics(jnp.zeros((B,), jnp.uint32), z)
    succ0 = succ0.at[:, 0].set(s0)
    succ1 = succ1.at[:, 0].set(s1)
    tm0 = tm0.at[:, 0].set(t0)
    tm1 = tm1.at[:, 0].set(t1)
    decoded = decoded.at[:, 0].set(dec0)

    cur = jnp.zeros((B,), jnp.int32)
    threshold = jnp.zeros((B,), mdtype)
    timeout = jnp.full((B,), timeout_per_bit * T, jnp.int32)
    mode = jnp.full((B,), _SEARCH)
    done = jnp.zeros((B,), bool)

    def g(arr, idx):
        return jnp.take_along_axis(arr, idx[:, None], axis=1)[:, 0]

    def put(arr, idx, val, maskv):
        old = jnp.take_along_axis(arr, idx[:, None], axis=1)[:, 0]
        return arr.at[arangeB, idx].set(jnp.where(maskv, val, old))

    def cond(carry):
        return ~jnp.all(carry[-1])

    def body(carry):
        (nstate, nmetric, succ0, succ1, tm0, tm1, selected, decoded,
         cur, threshold, timeout, mode, done) = carry

        search = (mode == _SEARCH) & ~done
        back = (mode == _BACKTRACK) & ~done

        # ---------------- SEARCH micro-step -------------------------------
        exhausted = search & (timeout == 0)
        done = done | exhausted
        act = search & ~exhausted
        timeout = jnp.where(act, timeout - 1, timeout)

        sel = g(selected, cur)
        m_cur = g(nmetric, cur)
        tsel = jnp.where(sel == 0, g(tm0, cur), g(tm1, cur))
        ms = (m_cur + tsel).astype(mdtype)
        fwd = act & (ms >= threshold)

        # tightening (exact closed form of the repeated-addition loop)
        gate = fwd & (m_cur < threshold + delta)
        if soft:
            k = jnp.floor((ms - threshold) / delta).astype(jnp.int32)
        else:
            k = (ms - threshold) // delta
        k = jnp.where(ms >= threshold + (k + 1) * delta, k + 1, k)
        k = jnp.where(ms < threshold + k * delta, k - 1, k)
        k = jnp.maximum(k, 0)
        threshold = jnp.where(gate, (threshold + k * delta).astype(mdtype), threshold)

        # forward move
        nxt = jnp.clip(cur + 1, 0, T - 1)
        finished = fwd & (cur + 1 == T)
        done = done | finished
        step_fwd = fwd & ~finished
        ssel = jnp.where(sel == 0, g(succ0, cur), g(succ1, cur))
        nstate = put(nstate, nxt, ssel, step_fwd)
        nmetric = put(nmetric, nxt, ms, step_fwd)
        cur = jnp.where(step_fwd, nxt, cur)
        # recompute branch data at the node we just entered
        b0, b1, bt0, bt1, bdec = node_metrics(g(nstate, cur),
                                              jnp.clip(cur, 0, T - 1))
        succ0 = put(succ0, cur, b0, step_fwd)
        succ1 = put(succ1, cur, b1, step_fwd)
        tm0 = put(tm0, cur, bt0, step_fwd)
        tm1 = put(tm1, cur, bt1, step_fwd)
        decoded = put(decoded, cur, bdec, step_fwd)
        selected = put(selected, cur, jnp.int8(0), step_fwd)

        # no forward: enter backtrack mode
        mode = jnp.where(act & ~fwd, _BACKTRACK, mode)

        # ---------------- BACKTRACK micro-step -----------------------------
        prev_ok = back & (cur > 0)
        pm = g(nmetric, jnp.clip(cur - 1, 0, T - 1))
        can_back = prev_ok & (pm >= threshold)
        relax = back & ~can_back
        # relax: lower threshold, restart from best branch of current node
        threshold = jnp.where(relax, (threshold - delta).astype(mdtype), threshold)
        sel_cur = g(selected, cur)
        flip_relax = relax & (sel_cur != 0)
        decoded = put(decoded, cur, g(decoded, cur) ^ 1, flip_relax)
        selected = put(selected, cur, jnp.int8(0), flip_relax)
        mode = jnp.where(relax, _SEARCH, mode)
        # move back one node; take its second branch if untested
        cur = jnp.where(can_back, cur - 1, cur)
        sel_b = g(selected, cur)
        take_second = can_back & (sel_b == 0)
        decoded = put(decoded, cur, g(decoded, cur) ^ 1, take_second)
        selected = put(selected, cur, jnp.int8(1), take_second)
        mode = jnp.where(take_second, _SEARCH, mode)
        # if selected was already 1, stay in BACKTRACK and keep moving back

        return (nstate, nmetric, succ0, succ1, tm0, tm1, selected, decoded,
                cur, threshold, timeout, mode, done)

    def body_n(carry):
        # masked micro-steps: extra iterations on done frames are no-ops
        for _ in range(unroll):
            carry = body(carry)
        return carry

    carry = (nstate, nmetric, succ0, succ1, tm0, tm1, selected, decoded,
             cur, threshold, timeout, mode, done)
    return carry, cond, body_n


def _fano_extract(code: Code, carry):
    decoded = carry[7]
    # per-frame diagnostics (the reference exposes the final metric through
    # the BSC callback and a compile-time VERBOSE trace; here it is data):
    # metric of the deepest settled node, remaining timeout budget, depth.
    diag = {
        "metric": jnp.take_along_axis(carry[1], carry[8][:, None], axis=1)[:, 0],
        "timeout_left": carry[10],
        "depth": carry[8],
        "timed_out": carry[10] == 0,
    }
    return decoded[:, : code.block_length].astype(jnp.int32), diag


def _fano_decode(code: Code, symbols: jnp.ndarray, soft: bool,
                 timeout_per_bit: int, unroll: int = 4):
    carry, cond, body_n = _fano_parts(code, symbols, soft, timeout_per_bit,
                                      unroll)
    carry = jax.lax.while_loop(cond, body_n, carry)
    return _fano_extract(code, carry)


@partial(jax.jit, static_argnums=(0, 2))
def fano_decode_soft(code: Code, distances: jnp.ndarray,
                     timeout_per_bit: int = FANO_TIMEOUT) -> jnp.ndarray:
    """``[B, T, 2^m]`` demapper distances → ``[B, block_len]`` decoded bits."""
    bits, _ = _fano_decode(code, distances.astype(jnp.float32), True,
                           timeout_per_bit)
    return bits


@partial(jax.jit, static_argnums=(0, 2))
def fano_decode_hard(code: Code, received: jnp.ndarray,
                     timeout_per_bit: int = FANO_TIMEOUT) -> jnp.ndarray:
    """``[B, T]`` received symbols → ``[B, block_len]`` decoded bits."""
    bits, _ = _fano_decode(code, received.astype(jnp.int32), False,
                           timeout_per_bit)
    return bits


@partial(jax.jit, static_argnums=(0, 2))
def fano_decode_soft_with_diag(code: Code, distances: jnp.ndarray,
                               timeout_per_bit: int = FANO_TIMEOUT):
    """Like :func:`fano_decode_soft` but also returns per-frame diagnostics
    {metric, timeout_left, depth, timed_out} — the observable state the
    reference exposes via its VERBOSE trace and metric callback
    (binary-symmetric-channel/fano-decoder.c:16-20, :313)."""
    return _fano_decode(code, distances.astype(jnp.float32), True,
                        timeout_per_bit)


@partial(jax.jit, static_argnums=(0, 2))
def fano_decode_hard_with_diag(code: Code, received: jnp.ndarray,
                               timeout_per_bit: int = FANO_TIMEOUT):
    return _fano_decode(code, received.astype(jnp.int32), False,
                        timeout_per_bit)
