"""Trellis tables vs brute-force golden-model register replay (SURVEY §4)."""

import numpy as np
import pytest

import golden_model as gm
from convolutional_codes.models.codebook import get_code, list_codes, Code
from convolutional_codes.models.trellis import (
    build_trellis, expected_symbols, next_states, quirk_mask_low,
    effective_parity_u64, parity_u64)


def test_quirk_masks():
    # K=3 codes are unaffected; K=4/5/6 have single-bit masks; WSPR hits P1.
    assert quirk_mask_low(3) == 0
    assert quirk_mask_low(4) == 0b0001
    assert quirk_mask_low(5) == 0b00010
    assert quirk_mask_low(6) == 0b000100
    assert quirk_mask_low(32) == 0x10101010


def test_parity_vs_golden_model():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 1 << 63, size=2000, dtype=np.uint64)
    for K in (3, 4, 6, 15, 32):
        # golden model works on 64-bit MSB-aligned registers
        ours = effective_parity_u64(vals >> np.uint64(64 - K), K)
        ref = np.array([gm.ref_parity64(int(v >> np.uint64(64 - K) << np.uint64(64 - K)), True)
                        for v in vals])
        assert np.array_equal(ours, ref)
    assert np.array_equal(parity_u64(vals),
                          np.array([bin(int(v)).count("1") & 1 for v in vals]))


@pytest.mark.parametrize("idx", [0, 1, 2, 3, 5])
def test_tables_vs_golden(idx):
    code = get_code(idx)
    K = code.constraint_length
    S = code.num_states
    tr = build_trellis(code)
    for s in range(S):
        for i in (0, 1):
            reg = (s << (64 - K)) | (i << 63)
            assert tr.expected_symbol[s, i] == gm.expected_symbol64(code, reg)
            assert tr.next_state[s, i] == ((s >> 1) | (i << (K - 2)))
    # butterfly view consistency
    for ns in range(S):
        i = tr.input_of[ns]
        for b in (0, 1):
            p = tr.prev_state[ns, b]
            assert tr.next_state[p, i] == ns
            assert tr.esym_prev[ns, b] == tr.expected_symbol[p, i]


def test_true_vs_compat_differ_only_where_expected():
    # codes 0 and 5: identical under both parities; codes 1-4: must differ.
    for idx, same in [(0, True), (1, False), (2, False), (3, False), (5, True)]:
        compat = get_code(idx)
        true = compat.replace(parity="true")
        s = np.arange(compat.num_states, dtype=np.int64)[:, None]
        i = np.arange(2, dtype=np.int64)[None, :]
        eq = np.array_equal(expected_symbols(compat, s, i), expected_symbols(true, s, i))
        assert eq == same, f"code {idx}"


def test_registry():
    codes = list_codes()
    assert all(k in codes for k in range(6))
    assert get_code("nasa-k7").polynomials == (0o171, 0o133)
    with pytest.raises(ValueError):
        Code(name="bad", symlen_out=2, constraint_length=3, block_length=10,
             polynomials=(0b1011, 0b11))  # poly too wide for K=3


def test_user_defined_code_end_to_end():
    """User extension flow (reference Readme.md:19): register a custom code
    and run the full encode → decode round trip."""
    import jax.numpy as jnp
    from convolutional_codes.models.codebook import register_code
    from convolutional_codes.ops.encoder import encode
    from convolutional_codes.ops.viterbi import viterbi_decode_hard

    custom = Code(name="custom-k4", symlen_out=2, constraint_length=4,
                  block_length=24, polynomials=(0o15, 0o17), parity="true")
    register_code("custom-k4", custom, overwrite=True)
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, size=(8, 24))
    syms = encode(custom, jnp.asarray(bits))
    dec, metric = viterbi_decode_hard(custom, syms)
    assert np.array_equal(np.asarray(dec), bits)
    assert np.all(np.asarray(metric) == 0)
