"""Time-block streaming Viterbi vs monolithic decode (SURVEY §7 step 8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.channels import awgn, awgn_sigma
from convolutional_codes.ops.demapper import soft_demap
from convolutional_codes.ops.encoder import encode_stream
from convolutional_codes.ops.mapper import map_symbols
from convolutional_codes.parallel.mesh import make_mesh
from convolutional_codes.parallel.streaming import (
    streaming_viterbi_decode, monolithic_reference_decode, dryrun_streaming)


def _noisy_frame(code, B, L, snr_db, seed):
    key = jax.random.PRNGKey(seed)
    kb, kn = jax.random.split(key)
    bits = jax.random.bernoulli(kb, 0.5, (B, L)).astype(jnp.int32)
    syms = encode_stream(code, bits, terminate=True)
    iq = map_symbols(code, syms)
    rx = awgn(kn, iq, awgn_sigma(snr_db))
    return bits, soft_demap(code.symlen_out, rx)


def test_encode_stream_long_frame_matches_blockwise_structure():
    code = get_code("nasa-k7")
    bits = np.zeros((1, 1000), np.int32)
    syms = np.asarray(encode_stream(code, jnp.asarray(bits)))
    assert syms.shape == (1, 1006)
    assert np.all(syms == 0)


@pytest.mark.parametrize("snr_db", [2.0, 6.0])
def test_streaming_matches_monolithic(snr_db):
    code = get_code("nasa-k7")
    D = 4
    T = D * 256
    L = T - (code.constraint_length - 1)
    bits, dists = _noisy_frame(code, B=2, L=L, snr_db=snr_db, seed=3)
    mono = np.asarray(monolithic_reference_decode(code, dists))
    mesh = make_mesh({"seq": D}, devices=jax.devices()[:D])
    stream = np.asarray(streaming_viterbi_decode(code, dists, mesh, warmup=96))
    assert np.array_equal(stream, mono), (
        f"{(stream != mono).sum()} mismatches of {mono.size}")


def test_streaming_decodes_noiseless_exactly():
    dryrun_streaming(8, interpret=True)


def test_streaming_ber_reasonable_at_low_snr():
    """Even when boundary effects could bite, BER must track monolithic."""
    code = get_code("nasa-k7")
    D = 8
    T = D * 128
    L = T - (code.constraint_length - 1)
    bits, dists = _noisy_frame(code, B=2, L=L, snr_db=1.0, seed=9)
    mono = np.asarray(monolithic_reference_decode(code, dists))[:, :L]
    mesh = make_mesh({"seq": D})
    stream = np.asarray(streaming_viterbi_decode(code, dists, mesh, warmup=96))[:, :L]
    b = np.asarray(bits)
    ber_mono = (mono != b).mean()
    ber_stream = (stream != b).mean()
    assert abs(ber_stream - ber_mono) < 0.01, (ber_stream, ber_mono)


def _bsc_longframe_ber(code, B, L, p, seed):
    """Decoded BER of a long unterminated BSC frame (bench config 0 shape)."""
    from convolutional_codes.ops.viterbi import hard_branch_metrics

    key = jax.random.PRNGKey(seed)
    bits = jax.random.bernoulli(key, 0.5, (B, L)).astype(jnp.int32)
    syms = encode_stream(code, bits, terminate=True)
    kf = jax.random.split(key)[0]
    flips = jax.random.bernoulli(kf, p, syms.shape + (code.symlen_out,))
    fl = jnp.sum(flips.astype(jnp.int32) << jnp.arange(code.symlen_out), -1)
    bm = hard_branch_metrics(code, syms ^ fl).astype(jnp.float32)
    out = monolithic_reference_decode(code, bm)
    return float(np.asarray(out[:, :L] != bits).mean())


def test_k3_75_long_frames_non_catastrophic():
    """BASELINE config 0 must use the (7,5) code: reference code 0
    (101,011) has generators sharing the factor (1+D) (catastrophic), so a
    1.25% BSC flip rate smears into order-0.5 BER on unterminated long
    frames, while (7,5) holds the short-block operating point."""
    ber_75 = _bsc_longframe_ber(get_code("k3-75"), B=4, L=4094,
                                p=0.0125, seed=7)
    ber_cat = _bsc_longframe_ber(get_code(0), B=4, L=4094,
                                 p=0.0125, seed=7)
    assert ber_75 < 0.02, ber_75
    assert ber_cat > 0.1, ber_cat


def test_fused_streaming_mc_shards_bit_identical():
    """Sequence-parallel fused streaming MC (each device decodes a distinct
    time range of the same hash-addressed streams, halos regenerated
    locally) must produce counters BIT-IDENTICAL to the monolithic
    mc_longframe_viterbi run."""
    from convolutional_codes.ops.viterbi_mc import mc_longframe_viterbi
    from convolutional_codes.parallel.streaming import (
        streaming_mc_accumulate)

    code = get_code("nasa-k7")
    lanes, windows, window, warmup = 16, 8, 96, 48
    param = 0.6
    be0, we0 = mc_longframe_viterbi(code, lanes, windows, 9, param,
                                    window=window, warmup=warmup,
                                    interpret=True)
    for D in (4, 8):
        mesh = make_mesh({"seq": D}, devices=jax.devices()[:D])
        be, we, nb = streaming_mc_accumulate(
            code, lanes, windows, 9, param, mesh, window=window,
            warmup=warmup, interpret=True)
        assert nb == lanes * windows * window
        assert np.array_equal(np.asarray(be), np.asarray(be0)), D
        assert np.array_equal(np.asarray(we), np.asarray(we0)), D
    assert int(np.asarray(be0).sum()) > 0
