#!/usr/bin/env python3
"""Benchmark: decoded info bits/s of the Monte-Carlo chains on the GPU.

    python bench.py         # headline only
    python bench.py --all   # every row, headline last

The headline runs the complete flagship pipeline (random info bits →
convolutional encoder → QPSK mapper → AWGN channel → soft demapper →
Viterbi decode → error count) for the default K=3 rate-1/2 code at 8 dB
Eb/N0 through the fused Viterbi kernel (ops/viterbi_mc.py).  Each row
prints one JSON line naming the platform, device kind and device count.
There is no CPU fallback: without a GPU the script exits non-zero.

Baselines are one-core rates of the C reference (BASELINE.md): ~6.6e6
info bits/s for the headline chain.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from convolutional_codes.models.codebook import PARITY_COMPAT, get_code
from convolutional_codes.ops.channels import awgn_sigma
from convolutional_codes.utils.compile_cache import enable_compile_cache

BASELINE_BITS_PER_S = 6.6e6   # reference C, 1 CPU core (BASELINE.md)


def _device():
    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def _emit(metric, bits, dt, baseline=None, **detail):
    r = {"metric": metric, "value": round(bits / dt, 1), "unit": "info_bits/s"}
    if baseline:
        r["vs_baseline"] = round(bits / dt / baseline, 3)
    r["detail"] = {**detail, **_device()}
    print(json.dumps(r), flush=True)


def _resolve_code(code_key):
    return code_key if not isinstance(code_key, (int, str)) else get_code(code_key)


def _bench_longframe(code_key, metric, channel, param, baseline,
                     window=1920, warmup=128, lanes=131072, nsteps=4,
                     calls=3):
    """Long-frame Monte-Carlo chain: every lane advances its own coded
    stream through overlap-save windows in the fused Viterbi kernel —
    the reference chains (binary-symmetric-channel/main.c:57-98,
    AWGN-channel/main.c:80-144) at frame lengths the reference's uint8
    block machinery cannot express."""
    from convolutional_codes.ops.viterbi_mc import mc_longframe_viterbi

    code = get_code(code_key)

    @jax.jit
    def run(seed):
        be, we = mc_longframe_viterbi(code, lanes, nsteps, seed, param,
                                      channel=channel, window=window,
                                      warmup=warmup)
        return be.sum(dtype=jnp.int32)

    jax.block_until_ready(run(jnp.int32(1)))       # compile + warm
    t0 = time.time()
    errs = [run(jnp.int32(100 + i)) for i in range(calls)]   # fresh seeds
    jax.block_until_ready(errs)
    dt = time.time() - t0
    bits = lanes * nsteps * window * calls
    _emit(metric, bits, dt, baseline, ber=sum(int(e) for e in errs) / bits,
          window=window, warmup=warmup, stream_lanes=lanes)


def _bench_streaming_fused_per_chip(metric, lanes=65536, windows=2,
                                    snr_db=6.0, calls=3):
    """Per-device rate of the sequence-parallel streaming mode
    (parallel/streaming.streaming_mc_accumulate on a 1-device 'seq'
    mesh): each device decodes a distinct time range of the same coded
    streams with locally regenerated halos; one psum of per-lane counters
    per call is the only collective."""
    from convolutional_codes.parallel.mesh import make_mesh
    from convolutional_codes.parallel.streaming import (
        streaming_mc_accumulate)

    code = get_code("nasa-k7")
    mesh = make_mesh({"seq": 1}, devices=jax.devices()[:1])
    param = float(awgn_sigma(snr_db))
    be, we, nb = streaming_mc_accumulate(code, lanes, windows, 1, param,
                                         mesh)                  # warm
    jax.block_until_ready(be)
    t0 = time.time()
    errs = 0
    for i in range(calls):
        be, we, nb = streaming_mc_accumulate(code, lanes, windows, 100 + i,
                                             param, mesh)
        errs += int(jnp.sum(be))
    dt = time.time() - t0
    _emit(metric, nb * calls, dt, None, ber=errs / (nb * calls))


def _bench_seq(decoder, code_key, metric, snr_db, baseline, lanes=8192,
               fpl=64, **extra):
    """Stack/Fano rows through the one-frame-per-thread kernel
    (ops/sequential_mc.py) — the production sweep path."""
    from convolutional_codes.ops.sequential_mc import mc_sequential

    code = _resolve_code(code_key)
    param = float(awgn_sigma(snr_db))
    mc_sequential(decoder, code, lanes, max(1, fpl // 8), 1, param)  # warm
    t0 = time.time()
    be, fe, nb = mc_sequential(decoder, code, lanes, fpl, 4242, param)
    dt = time.time() - t0
    _emit(metric, nb, dt, baseline, snr_db=snr_db, ber=be / nb,
          frames=lanes * fpl, **extra)


def _bench_headline(B=1048576, nsteps=16, calls=4):
    """The full AWGN soft-Viterbi chain of code 0 at 8 dB through the fused
    Viterbi kernel, ``nsteps`` Monte-Carlo steps of ``B`` frames per call."""
    from convolutional_codes.ops.viterbi_mc import mc_chain_viterbi

    code = get_code(0)
    sigma = jnp.float32(awgn_sigma(8.0))

    @jax.jit
    def many(seed):
        be, fe = mc_chain_viterbi(code, B, nsteps, seed, sigma)
        return be.sum(dtype=jnp.int32)

    jax.block_until_ready(many(jnp.int32(1)))      # compile + warm
    t0 = time.time()
    errs = [many(jnp.int32(100 + i)) for i in range(calls)]  # fresh seeds
    jax.block_until_ready(errs)
    dt = time.time() - t0
    tot_bits = B * code.block_length * nsteps * calls
    _emit("awgn_soft_viterbi_k3_full_chain_throughput", tot_bits, dt,
          BASELINE_BITS_PER_S, ber_at_8db=sum(int(e) for e in errs) / tot_bits,
          published_ber=1.3756e-4, info_bits=tot_bits)


def bench_all():
    """One JSON line per row; main() prints the headline last."""
    # K=3 (7,5) hard Viterbi, BSC, million-bit streaming frames.  The
    # classic non-catastrophic (7,5) code: reference code 0 (101,011) is
    # catastrophic (shared (1+D) factor) and only usable on short
    # terminated blocks, not million-bit streams.
    _bench_longframe("k3-75", "bsc_hard_viterbi_k3_1e6bit_frames", "bsc",
                     0.0125, baseline=9.4e6)
    # K=7 NASA soft Viterbi, long streaming frames
    _bench_longframe("nasa-k7", "awgn_soft_viterbi_k7_streaming", "awgn",
                     float(awgn_sigma(6.0)), baseline=None, lanes=65536,
                     nsteps=2)
    _bench_streaming_fused_per_chip("awgn_k7_streaming_fused_per_chip")
    # Sequential rows.  Baselines are same-config same-SNR rates of the
    # C chain on one CPU core (tools/bench_reference_ext.py,
    # results/reference_fresh_awgn_ext.json).  The C parity routine is the
    # compat quirk (SURVEY §2c), which rewires the extension codes, so
    # ratio rows run parity=compat on both sides; the true-parity rows
    # carry no C baseline (the reference cannot express those codes).
    _bench_seq("stack", "k9-r12", "awgn_stack_k9_soft", 8.0, None, fpl=256)
    _bench_seq("stack", get_code("k9-r12").replace(parity=PARITY_COMPAT),
               "awgn_stack_k9_soft_compat_vs_c", 8.0, 3.96e5, fpl=32,
               parity="compat")
    # flagship-code sequential rows (code 0 is quirk-free: compat == true)
    _bench_seq("stack", 0, "awgn_stack_k3_soft", 8.0, 4.12e6, fpl=512)
    _bench_seq("fano", 0, "awgn_fano_k3_soft", 8.0, 7.22e5, fpl=128)
    # fano on K=15 + 16-QAM soft demapper; the compat twin runs the
    # quirk-rewired code the C binary simulates (heavy-tailed walks)
    _bench_seq("fano", "k15-r14-16qam", "awgn_fano_k15_16qam", 14.0, None,
               fpl=256)
    _bench_seq("fano", get_code("k15-r14-16qam").replace(parity=PARITY_COMPAT),
               "awgn_fano_k15_16qam_compat_vs_c", 14.0, 1.11e6, fpl=4,
               parity="compat")


def main():
    if jax.devices()[0].platform != "gpu":
        print(json.dumps({"metric": "bench_unavailable", "value": 0,
                          "unit": "", "detail": {
                              "reason": "no GPU; this benchmark measures "
                                        "the card only", **_device()}}),
              flush=True)
        return 3
    enable_compile_cache()
    if "--all" in sys.argv:
        bench_all()
    _bench_headline()
    return 0


if __name__ == "__main__":
    sys.exit(main())
