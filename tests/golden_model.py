"""Scalar NumPy golden model of the reference simulator's behavioral contract.

This is an *independent reimplementation* (clean-room from the behavioral
analysis in SURVEY.md, citations inline) of the reference pipeline stages,
used as the test oracle for the framework.  It is deliberately scalar and
structured like the spec, not like the vectorized code, so agreement between the two
is meaningful.  It was cross-validated bit-for-bit against harnesses compiled
from the actual C reference (see tools/golden_harness/) before the fixtures
in tests/goldens/ were pinned.

All float arithmetic uses np.float32 to match the C reference's ``float``.
"""

from __future__ import annotations

import numpy as np

from convolutional_codes.models.codebook import Code, PARITY_COMPAT
from convolutional_codes.models.constellations import get_constellation

F32 = np.float32
_MASK64 = (1 << 64) - 1

STACK_DEPTH = 64          # AWGN-channel/stack-decoder.c:12
FANO_TIMEOUT = 10000      # AWGN-channel/fano-decoder.c:14
FANO_DELTA = 17.0         # AWGN-channel/fano-decoder.c:15


# ---------------------------------------------------------------------------
# Parity / expected symbols (encoder.c:92-100 incl. the unmasked-shift quirk)
# ---------------------------------------------------------------------------

def ref_parity64(val: int, compat: bool) -> int:
    if not compat:
        return bin(val).count("1") & 1
    val &= _MASK64
    val ^= val >> 32
    val ^= val >> 16
    val ^= val >> 8
    val ^= (val >> 4) & 0x0F
    return (0x6996 >> (val & 31)) & 1  # x86 masks the 32-bit shift count


def _polys64(code: Code):
    K = code.constraint_length
    return [p << (64 - K) for p in code.polynomials]


def expected_symbol64(code: Code, register: int) -> int:
    compat = code.parity == PARITY_COMPAT
    sym = 0
    for p in _polys64(code):
        sym = (sym << 1) | ref_parity64(register & p, compat)
    return sym


# ---------------------------------------------------------------------------
# Encoder (encoder.c:84-118)
# ---------------------------------------------------------------------------

def encode_block(code: Code, bits) -> np.ndarray:
    """Info bits (len block_length, values 0/1) → T symbols incl. tail."""
    K, L = code.constraint_length, code.block_length
    assert len(bits) == L
    register = 0
    out = []
    for b in list(bits) + [0] * (K - 1):
        register = (register >> 1) | (int(b) << 63)
        out.append(expected_symbol64(code, register))
    return np.array(out, dtype=np.int64)


# ---------------------------------------------------------------------------
# Mapper / channels / demappers (mapper.c, main.c callbacks, demapper.c,
# hard-demapper.c)
# ---------------------------------------------------------------------------

def map_symbols(num_bits: int, symbols) -> np.ndarray:
    return get_constellation(num_bits)[np.asarray(symbols)]


def _ndist(num_bits: int) -> F32:
    c = get_constellation(num_bits)
    dx, dy = F32(c[0, 0] - c[1, 0]), F32(c[0, 1] - c[1, 1])
    return F32(dx * dx + dy * dy)


def soft_demap(num_bits: int, iq) -> np.ndarray:
    c = get_constellation(num_bits)
    iq = np.asarray(iq, dtype=F32)
    d = iq[..., None, :] - c
    return ((d * d).sum(-1, dtype=F32) / _ndist(num_bits)).astype(F32)


def hard_demap(num_bits: int, iq) -> np.ndarray:
    c = get_constellation(num_bits)
    iq = np.asarray(iq, dtype=F32)
    d = iq[..., None, :] - c
    raw = (d * d).sum(-1, dtype=F32)
    snapped = c[np.argmin(raw, axis=-1)]
    d2 = snapped[..., None, :] - c
    return ((d2 * d2).sum(-1, dtype=F32) / _ndist(num_bits)).astype(F32)


def bsc_flip(symbols, flip_masks) -> np.ndarray:
    return np.asarray(symbols) ^ np.asarray(flip_masks)


# ---------------------------------------------------------------------------
# Viterbi (AWGN-channel/viterbi-decoder.c soft,
#          binary-symmetric-channel/viterbi-decoder.c hard)
# ---------------------------------------------------------------------------

def _viterbi(code: Code, branch_metric_fn, T: int, hard: bool):
    K = code.constraint_length
    S = 1 << (K - 1)
    INF = 0xFF00 if hard else np.inf
    metrics = [INF] * S
    metrics[0] = 0
    dec = []  # per t: list of (prev_idx, input) per new state
    for t in range(T):
        new = [INF] * S
        dt = [(0, 0)] * S
        for s in range(S):
            for i in (0, 1):
                register = (s << (64 - K)) | (i << 63)
                esym = expected_symbol64(code, register)
                ns = (s >> 1) | (i << (K - 2))
                m = metrics[s] + branch_metric_fn(t, esym)
                if hard:
                    m = min(m, 0xFF00)
                else:
                    m = F32(m)
                if m < new[ns]:
                    new[ns] = m
                    dt[ns] = (s, i)
        metrics = new
        dec.append(dt)
    # traceback from global-min end state (first-wins)
    cur = int(np.argmin(metrics))
    min_metric = metrics[cur]
    bits = [0] * T
    for t in range(T - 1, -1, -1):
        prev, inp = dec[t][cur]
        bits[t] = inp
        cur = prev
    return np.array(bits[: code.block_length], dtype=np.int64), min_metric


def viterbi_soft(code: Code, distances) -> np.ndarray:
    """distances: [T, 2^m] float — demapper output per symbol."""
    distances = np.asarray(distances, dtype=F32)
    bits, _ = _viterbi(code, lambda t, e: distances[t][e], len(distances), hard=False)
    return bits


def viterbi_hard(code: Code, received):
    """received: [T] int symbols. Returns (bits, path_metric)."""
    received = np.asarray(received)
    T = len(received)
    bits, metric = _viterbi(
        code, lambda t, e: bin(e ^ int(received[t])).count("1"), T, hard=True)
    return bits, metric


# ---------------------------------------------------------------------------
# Stack decoder (AWGN-channel/stack-decoder.c soft,
#                binary-symmetric-channel/stack-decoder.c hard)
# ---------------------------------------------------------------------------

class _Path:
    __slots__ = ("nii", "state", "metric", "bits")

    def __init__(self, T):
        self.nii = 0          # next input symbol index
        self.state = 0        # encoder state (low-bit form, K-1 bits... kept 64-bit wide)
        self.metric = F32(0.0)
        self.bits = [0] * T


def _stack_transition(code: Code, state: int, soft_dist, hard_sym, soft: bool):
    """Both branch extensions from ``state``. Mirrors get_transition_metric
    (stack-decoder.c:243-276 / BSC :236-274): register = state << (64-K) with
    the input bit at bit 63; new_state includes the input bit as its MSB."""
    K = code.constraint_length
    out = []
    for i in (0, 1):
        register = ((state << (64 - K)) | (i << 63)) & _MASK64
        esym = expected_symbol64(code, register)
        new_state = register >> (64 + 1 - K)
        if soft:
            tm = F32(1.0 + F32(code.metric_weight) * F32(soft_dist[esym]))
        else:
            h = bin(esym ^ hard_sym).count("1")
            tm = h * code.bit_metrics[1] + (code.symlen_out - h) * code.bit_metrics[0]
        out.append((new_state, tm))
    return out


def _stack_decode(code: Code, symbols, soft: bool) -> np.ndarray:
    """symbols: [T, 2^m] distances (soft) or [T] ints (hard)."""
    T = code.num_block_symbols
    paths = [_Path(T)]
    for widx in range(1, T + 1):  # widx = symbols received so far
        cur = max(range(len(paths)), key=lambda k: (paths[k].metric, -k))
        while paths[cur].nii != widx:
            p = paths[cur]
            trans = _stack_transition(
                code, p.state,
                symbols[p.nii] if soft else None,
                None if soft else int(symbols[p.nii]),
                soft)
            # duplicate: append if below capacity, else overwrite the
            # least-probable path (first-wins scan, stack-decoder.c:227-241)
            if len(paths) < STACK_DEPTH:
                q = _Path(T)
                paths.append(q)
                new = len(paths) - 1
            else:
                new = min(range(len(paths)), key=lambda k: (paths[k].metric, k))
                q = paths[new]
            q.nii, q.state, q.metric = p.nii, p.state, p.metric
            q.bits = list(p.bits)
            # extend original with input 0, duplicate with input 1
            for sel, pp in ((0, p), (1, q)):
                out_idx = pp.nii
                pp.nii += 1
                pp.state, tm = trans[sel]
                pp.metric = F32(pp.metric + tm) if soft else pp.metric + trans[sel][1]
                pp.bits[out_idx] = sel
            cur = max(range(len(paths)), key=lambda k: (paths[k].metric, -k))
    return np.array(paths[cur].bits[: code.block_length], dtype=np.int64)


def stack_soft(code: Code, distances) -> np.ndarray:
    return _stack_decode(code, np.asarray(distances, dtype=F32), soft=True)


def stack_hard(code: Code, received) -> np.ndarray:
    return _stack_decode(code, np.asarray(received), soft=False)


# ---------------------------------------------------------------------------
# Fano decoder (AWGN-channel/fano-decoder.c soft,
#               binary-symmetric-channel/fano-decoder.c hard)
# ---------------------------------------------------------------------------

def _fano_transition(code: Code, state: int, soft_dist, hard_sym, soft: bool):
    """Mirrors fano get_transition_metric (AWGN :288-312, BSC :284-323):
    input 0 first (bit 63 clear), then input 1."""
    K = code.constraint_length
    out = []
    register = (state << (64 - K)) & _MASK64
    for i in (0, 1):
        if i == 1:
            register |= 1 << 63
        esym = expected_symbol64(code, register)
        new_state = register >> (64 + 1 - K)
        if soft:
            tm = F32(1.0 + F32(code.fano_metric_weight) * F32(soft_dist[esym]))
        else:
            h = bin(esym ^ hard_sym).count("1")
            tm = (h * code.fano_bit_metrics[1]
                  + (code.symlen_out - h) * code.fano_bit_metrics[0])
        out.append((new_state, tm))
    return out


def _fano_decode(code: Code, symbols, soft: bool, timeout_per_bit: int = FANO_TIMEOUT):
    T = code.num_block_symbols
    delta = F32(FANO_DELTA) if soft else 17
    zero = F32(0.0) if soft else 0

    class Node:
        __slots__ = ("state", "metric", "selected", "tm", "succ", "decoded")

        def __init__(self):
            self.state = 0
            self.metric = zero
            self.selected = 0
            self.tm = [zero, zero]
            self.succ = [0, 0]
            self.decoded = 0

    nodes = [Node() for _ in range(T)]
    threshold = zero
    timeout = timeout_per_bit * T
    cur = 0          # index of current node
    ignore = False

    def compute(n, t):
        trans = _fano_transition(
            code, n.state,
            symbols[t] if soft else None,
            None if soft else int(symbols[t]),
            soft)
        n.succ = [trans[0][0], trans[1][0]]
        n.tm = [trans[0][1], trans[1][1]]
        n.decoded = 0
        n.selected = 0
        if n.tm[0] < n.tm[1]:
            n.succ.reverse()
            n.tm.reverse()
            n.decoded = 1

    for received in range(1, T + 1):  # symbols available so far
        if ignore:
            continue
        t = received - 1
        n = nodes[cur]
        # metrics for the newly available symbol at the current node
        compute(n, cur)  # current node consumes symbol index == its position
        moved_out = False
        while timeout != 0:
            timeout -= 1
            n = nodes[cur]
            ms = (F32(n.metric + n.tm[n.selected]) if soft
                  else n.metric + n.tm[n.selected])
            if ms >= threshold:
                # tightening (fano-decoder.c:190-195)
                if n.metric < (threshold + delta):
                    while ms >= threshold + delta:
                        threshold = F32(threshold + delta) if soft else threshold + delta
                # move forward
                nxt = cur + 1
                if nxt == T:
                    return _fano_emit(code, nodes), False
                nodes[nxt].state = n.succ[n.selected]
                nodes[nxt].metric = ms
                cur = nxt
                if cur == received:      # caught up with available input
                    moved_out = True
                    break
                compute(nodes[cur], cur)
            else:
                while True:
                    if cur == 0 or nodes[cur - 1].metric < threshold:
                        threshold = (F32(threshold - delta) if soft
                                     else threshold - delta)
                        if nodes[cur].selected != 0:
                            nodes[cur].selected = 0
                            nodes[cur].decoded ^= 1
                        break
                    cur -= 1
                    if nodes[cur].selected == 0:
                        nodes[cur].selected = 1
                        nodes[cur].decoded ^= 1
                        break
        if not moved_out and timeout == 0:
            if received == T:
                return _fano_emit(code, nodes), True
            ignore = True
    return _fano_emit(code, nodes), ignore


def _fano_emit(code: Code, nodes) -> np.ndarray:
    bits = np.array([n.decoded for n in nodes], dtype=np.int64)
    return bits[: code.block_length]


def fano_soft(code: Code, distances, timeout_per_bit: int = FANO_TIMEOUT):
    bits, timed_out = _fano_decode(code, np.asarray(distances, dtype=F32), True,
                                   timeout_per_bit)
    return bits


def fano_hard(code: Code, received, timeout_per_bit: int = FANO_TIMEOUT):
    bits, timed_out = _fano_decode(code, np.asarray(received), False,
                                   timeout_per_bit)
    return bits
