"""End-to-end simulation chains as single pure step functions.

Each chain mirrors one reference pipeline (SURVEY.md §1):
  * awgn:    RNG bits → encoder → mapper → +noise → demapper → decoder
             (``AWGN-channel/main.c:80-144``)
  * bsc:     RNG bits → encoder → bit flips → hard decoder
             (``binary-symmetric-channel/main.c:57-98``)
  * uncoded: RNG symbols → mapper → +noise → demapper → argmin
             (``uncoded/main.c:77-122``)

A step takes (key, channel_param) and returns error counters for one batch
of frames — everything inside is jit-compatible, so sweeps scan over steps
on-device and shard over meshes without host round-trips.
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from convolutional_codes.models.codebook import Code
from convolutional_codes.ops.encoder import encode
from convolutional_codes.ops.mapper import map_symbols, map_symbols_m
from convolutional_codes.ops.demapper import soft_demap, hard_demap, hard_decide
from convolutional_codes.ops.channels import awgn, bsc
from convolutional_codes.ops.viterbi import viterbi_decode_soft, viterbi_decode_hard
from convolutional_codes.ops.stack import stack_decode_soft, stack_decode_hard
from convolutional_codes.ops.fano import fano_decode_soft, fano_decode_hard
from convolutional_codes.ops.fano import FANO_TIMEOUT
from convolutional_codes.utils.bitops import popcount32

CHANNELS = ("awgn", "bsc")
DEMAPPERS = ("soft", "hard")
DECODERS = ("viterbi", "stack", "fano")

StepFn = Callable[[jax.Array, jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]


def make_point_step(code: Code, channel: str, decoder: str,
                    demapper: str = "soft", frames: int = 1024,
                    timeout_per_bit: int = FANO_TIMEOUT) -> StepFn:
    """Build ``step(key, param) -> (bit_errors, frame_errors, bits)`` for one
    sweep point.  ``param`` is the AWGN per-component sigma or the BSC
    crossover probability.  All outputs are int32/int64 scalars (on device).
    """
    if channel not in CHANNELS:
        raise ValueError(f"channel must be one of {CHANNELS}, got {channel!r}")
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    if demapper not in DEMAPPERS:
        raise ValueError(f"demapper must be one of {DEMAPPERS}, got {demapper!r}")

    L, m = code.block_length, code.symlen_out

    def step(key: jax.Array, param) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        kb, kc = jax.random.split(key)
        bits = jax.random.bernoulli(kb, 0.5, (frames, L)).astype(jnp.int32)
        syms = encode(code, bits)
        if channel == "awgn":
            iq = map_symbols(code, syms)
            rx = awgn(kc, iq, jnp.asarray(param, jnp.float32))
            demap = soft_demap if demapper == "soft" else hard_demap
            dists = demap(m, rx)
            if decoder == "viterbi":
                dec = viterbi_decode_soft(code, dists)
            elif decoder == "stack":
                dec = stack_decode_soft(code, dists)
            else:
                dec = fano_decode_soft(code, dists, timeout_per_bit)
        else:
            rx = bsc(kc, syms, jnp.asarray(param, jnp.float32), num_bits=m)
            if decoder == "viterbi":
                dec, _metric = viterbi_decode_hard(code, rx)
            elif decoder == "stack":
                dec = stack_decode_hard(code, rx)
            else:
                dec = fano_decode_hard(code, rx, timeout_per_bit)
        errs = dec != bits
        bit_errors = errs.sum(dtype=jnp.int32)
        frame_errors = errs.any(axis=-1).sum(dtype=jnp.int32)
        return bit_errors, frame_errors, jnp.int32(frames * L)

    return step


def make_uncoded_step(num_bits: int, frames: int = 1 << 16) -> StepFn:
    """Uncoded baseline: random symbols → map → AWGN → demap → nearest-point
    decision → popcount bit errors (``uncoded/main.c:104-119``).  ``param``
    is the per-component sigma (already including the Es/N0 conversion)."""

    def step(key: jax.Array, param):
        ks, kn = jax.random.split(key)
        syms = jax.random.randint(ks, (frames,), 0, 1 << num_bits, dtype=jnp.int32)
        iq = map_symbols_m(num_bits, syms)
        rx = awgn(kn, iq, jnp.asarray(param, jnp.float32))
        dec = hard_decide(num_bits, rx)
        bit_errors = popcount32(dec ^ syms).sum(dtype=jnp.int32)
        sym_errors = (dec != syms).sum(dtype=jnp.int32)
        return bit_errors, sym_errors, jnp.int32(frames * num_bits)

    return step
