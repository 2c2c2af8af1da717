"""Coordinate-hash Monte-Carlo frame generation.

One pure function of (seed, global frame id, symbol position) produces a
frame's info bits and channel output: encoder parity (with the compat
quirk), mapper, Box-Muller AWGN or BSC flips, and the soft/hard demapper,
over the coordinate hash of ops/coord_hash.  The elementwise stage helpers
(:func:`stage_fns`) are shared with the Viterbi Monte-Carlo kernel
(ops/viterbi_mc.py), so the kernel and the XLA replica used by tests
evaluate the same expressions.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from convolutional_codes.models.codebook import PARITY_COMPAT, Code
from convolutional_codes.models.constellations import (
    get_constellation, min_sq_distance)
from convolutional_codes.models.trellis import quirk_mask_low
from convolutional_codes.ops.coord_hash import TWO_PI, coord_bits, coord_uniform
from convolutional_codes.ops.sequential_common import force_rounded


def _parity_u32(x: jnp.ndarray) -> jnp.ndarray:
    x = x ^ (x >> 16)
    x = x ^ (x >> 8)
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & np.uint32(1)


def stage_fns(code: Code):
    """Elementwise stage helpers that work unchanged on any array shape
    (``(Bt,)`` rows inside a kernel, ``[N, T]`` planes on the host), with
    the same float expressions everywhere.  Takes a bare :class:`Code` (no
    dense trellis: the big-K sequential codes like WSPR K=32 have no
    enumerable state table).  Returns (esym_of, hard_dists, tx_select,
    dist_vec, snap).

    Every product that feeds an add, here or in the caller's metric sums,
    is rounded first
    (sequential_common.force_rounded): compilers contract ``a*b + c`` into
    one FMA wherever they choose, and a kernel and its XLA replica must
    round the same way to decode the same frames identically."""
    M = code.points_per_symbol
    symlen = code.symlen_out
    points = get_constellation(symlen)
    polys = [int(p) for p in code.polynomials]
    K = code.constraint_length
    qmask = quirk_mask_low(K) if code.parity == PARITY_COMPAT else 0
    # python float: a jnp scalar here would be a captured constant, which
    # Pallas kernels reject
    inv_nd = float(1.0 / min_sq_distance(symlen))

    def esym_of(reg):
        """encoder parity per polynomial (incl. compat quirk)."""
        esym = jnp.zeros(reg.shape, jnp.uint32)
        for p in polys:
            x = reg & np.uint32(p)
            bit = _parity_u32(x)
            if qmask:
                bit = bit & (np.uint32(1) - _parity_u32(x & np.uint32(qmask)))
            esym = (esym << 1) | bit
        return esym

    def hard_dists(rx):
        """Hamming distance vector to every expected symbol."""
        out = []
        for e in range(M):
            x = rx ^ np.uint32(e)
            h = x & np.uint32(1)
            for k in range(1, symlen):
                h = h + ((x >> k) & np.uint32(1))
            out.append(h.astype(jnp.int32).astype(jnp.float32))
        return out

    def tx_select(esym):
        """symbol index → (I, Q) via a static where-chain (mapper.c:54-71)."""
        txi = jnp.full(esym.shape, float(points[0, 0]), jnp.float32)
        txq = jnp.full(esym.shape, float(points[0, 1]), jnp.float32)
        for e in range(1, M):
            hit = esym == e
            txi = jnp.where(hit, float(points[e, 0]), txi)
            txq = jnp.where(hit, float(points[e, 1]), txq)
        return txi, txq

    def dist_vec(rxi, rxq):
        """normalized squared-distance vector (demapper.c:61-85)."""
        out = []
        for e in range(M):
            di = rxi - float(points[e, 0])
            dq = rxq - float(points[e, 1])
            out.append(force_rounded(
                (force_rounded(di * di) + force_rounded(dq * dq))
                * jnp.float32(inv_nd)))
        return out

    def snap(dists):
        """snap-then-distance (hard-demapper.c:66-87): pick the nearest
        point (strict less, first wins) and return its coordinates —
        downstream soft metrics run unchanged on the re-derived vector."""
        best = dists[0]
        sxi = jnp.full(best.shape, float(points[0, 0]), jnp.float32)
        sxq = jnp.full(best.shape, float(points[0, 1]), jnp.float32)
        for e in range(1, M):
            better = dists[e] < best
            best = jnp.where(better, dists[e], best)
            sxi = jnp.where(better, float(points[e, 0]), sxi)
            sxq = jnp.where(better, float(points[e, 1]), sxq)
        return sxi, sxq

    return esym_of, hard_dists, tx_select, dist_vec, snap


def channel_fns(code: Code, channel: str, demapper: str):
    """``(esym, ident, pos, seed, param) -> branch-metric vector`` — the
    channel and demapper half of the chain for one position, shared by
    :func:`make_datagen` and the Viterbi kernel.  "awgn": Box-Muller noise
    from draws 1-2 and soft distances (snapped for the hard demapper);
    "bsc": one flip draw per coded bit (salts 1..m), Hamming distances of
    the received symbol, which the second return value carries."""
    symlen = code.symlen_out
    _, hard_dists, tx_select, dist_vec, snap = stage_fns(code)

    def awgn(esym, ident, pos, seed, param):
        u0 = coord_uniform(ident, pos, seed, 1)
        u1 = coord_uniform(ident, pos, seed, 2)
        r = jnp.sqrt(-2.0 * jnp.log(u0))
        theta = jnp.float32(TWO_PI) * u1
        txi, txq = tx_select(esym)
        rxi = txi + force_rounded(param * (r * jnp.cos(theta)))
        rxq = txq + force_rounded(param * (r * jnp.sin(theta)))
        dvec = dist_vec(rxi, rxq)
        if demapper == "hard":
            dvec = dist_vec(*snap(dvec))
        return dvec, None

    def bsc(esym, ident, pos, seed, param):
        fmask = jnp.zeros(esym.shape, jnp.uint32)
        for k in range(symlen):
            fk = (coord_uniform(ident, pos, seed, 1 + k)
                  < param).astype(jnp.uint32)
            fmask = fmask | (fk << k)
        rx = esym ^ fmask
        return hard_dists(rx), rx

    return awgn if channel == "awgn" else bsc


def make_datagen(code: Code, T: int, L: int, channel: str,
                 demapper: str):
    """Returns ``gen(gid, row, seed, param) -> (bits, syms)``.

    ``gid`` ``[N, 1]`` global frame ids and ``row`` ``[1, T]`` symbol
    positions; ``bits`` is the ``[N, T]`` info-bit plane (tail positions
    zeroed), ``syms`` the ``[N, T, 2^m]`` demapper distances (soft
    channels) or ``[N, T]`` received symbols (BSC).
    """
    K = code.constraint_length
    soft = channel == "awgn"
    esym_of = stage_fns(code)[0]
    chan = channel_fns(code, channel, demapper)

    def gen(gid, row, seed, param):
        live = row < L
        bits = jnp.where(live,
                         (coord_bits(gid, row, seed, 0) & 1).astype(jnp.int32),
                         0)
        # register plane via K shifted views along the symbol axis
        bplane = bits.astype(jnp.uint32)
        reg = bplane << (K - 1)
        for j in range(1, K):
            shifted = jnp.concatenate(
                [jnp.zeros(bplane.shape[:1] + (j,), jnp.uint32),
                 bplane[:, :T - j]], axis=1)
            reg = reg | (shifted << (K - 1 - j))
        dvec, rx = chan(esym_of(reg), gid, row, seed, param)
        syms = jnp.stack(dvec, axis=-1) if soft else rx.astype(jnp.int32)
        return bits, syms

    return gen


def frames_host(code: Code, gids: np.ndarray, seed: int, param: float,
                channel: str, demapper: str = "soft"):
    """Host replica: the exact (bits [N, T], syms) frames of global frame
    ids ``gids`` — decode them with the XLA machines to cross-check the
    kernels' error counts."""
    T = code.num_block_symbols
    gen = make_datagen(code, T, code.block_length, channel, demapper)
    g = jnp.asarray(gids, jnp.int32)[:, None]
    t = jnp.arange(T)[None, :]
    bits, syms = gen(g, t, jnp.uint32(int(seed) & 0x7FFFFFFF),
                     jnp.float32(param))
    return np.asarray(bits), np.asarray(syms)
