#!/usr/bin/env python3
"""Smoke run of the Monte-Carlo sweep and its kernels on one NVIDIA GPU.

    python3 chip_smoke.py               # one card: phases 0-3
    python3 chip_smoke.py --four-cards  # four cards: the mesh phase only

Phases (each prints its own lines; any failure raises and the script exits
non-zero):

  0. the card's name and power limit, its device kind, the compile cache;
  1. four sweep points at the reference's sample tiers through
     ``sim.sweep.run_sweep`` (code 0: AWGN soft Viterbi at 8 dB, BSC hard
     Viterbi at p=0.0125, AWGN stack and Fano at 8 dB), each held to the
     published curve by ``tools/reproduce_curves.compare``;
  2. every kernel against its plain XLA reference at production widths:
     identical counters or decoded bits, and warm times of both;
  3. the real-data decode path, ``streaming_viterbi_decode`` against
     ``monolithic_reference_decode``.

The four-card phase runs a Viterbi grid on a sweep=2 x frames=2 mesh and a
stack grid through ``seq_mc_grid`` against the same points run serially
on one card; the counters must be identical.

The last line of standard output is one JSON object naming the device.
There is no fallback: without a GPU the script exits non-zero and prints
no result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def warm_time(fn, args_list):
    """Median wall seconds of ``fn(*args)`` over ``args_list`` (fresh inputs
    per call), each ending in block_until_ready; the first call compiles."""
    import jax
    times = []
    for args in args_list:
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    warm = sorted(times[1:])
    return times[0], warm[len(warm) // 2]


def phase_device(jax):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    from convolutional_codes.utils.compile_cache import enable_compile_cache
    cache = enable_compile_cache()
    log(f"[0] card: {smi.stdout.strip().splitlines()[0]}")
    log(f"[0] jax: {jax.__version__} device_kind={jax.devices()[0].device_kind}"
        f" count={len(jax.devices())} compile_cache={cache}")


def phase_sweep():
    from convolutional_codes.sim.sweep import SweepSpec, run_sweep
    from tools.reproduce_curves import Z_THRESHOLD, compare

    points = [
        # (spec, published row, channel)
        (SweepSpec(code=0, channel="awgn", decoder="viterbi", points=[8.0],
                   frames_per_step=1 << 20, seed=1), "ber_coded_a", "awgn"),
        (SweepSpec(code=0, channel="bsc", decoder="viterbi",
                   points=[0.0125], frames_per_step=1 << 20, seed=2),
         "ber_coded_a", "bsc"),
        (SweepSpec(code=0, channel="awgn", decoder="stack", points=[8.0],
                   seed=3), "ber_coded_a_stack", "awgn"),
        (SweepSpec(code=0, channel="awgn", decoder="fano", points=[8.0],
                   seed=4), "ber_coded_a_fano", "awgn"),
    ]
    for spec, row, channel in points:
        t0 = time.perf_counter()
        recs = run_sweep(spec, verbose=False)
        wall = time.perf_counter() - t0
        lines, worst = compare(recs, channel, row)
        r = recs[0]
        setup = wall - (r.warm_wall_s or 0.0)
        log(f"[1] {channel}/{spec.decoder} code 0 point={r.point:g}: "
            f"bits={r.bits} BER={r.ber:.6e} |z|={worst:.2f} "
            f"warm={r.bits_per_s:.4e} info bits/s "
            f"set-up incl. compile={setup:.1f} s")
        for line in lines:
            log(f"[1]   {line.strip()}")
        if not worst < Z_THRESHOLD:
            raise AssertionError(f"{channel}/{spec.decoder}: |z|={worst:.2f}"
                                 f" >= {Z_THRESHOLD}")


def phase_viterbi_kernel(jax, jnp, np):
    from convolutional_codes.models.codebook import get_code
    from convolutional_codes.ops import viterbi_mc as vm
    from convolutional_codes.ops.channels import awgn_sigma
    from convolutional_codes.sim.chain import make_point_step

    cases = [
        # (code, channel, param, batch, kernel steps per call)
        (0, "awgn", float(awgn_sigma(4.0)), 1 << 20, 4),
        ("nasa-k7", "awgn", float(awgn_sigma(3.0)), 1 << 17, 2),
    ]
    for ck, channel, param, B, nsteps in cases:
        code = get_code(ck)
        L = code.block_length
        # counters: kernel vs the XLA replica of the same frames
        be, fe = vm.mc_chain_viterbi(code, B, 1, 7, param, channel)
        rb, rf = vm.replica_counts(code, B, 1, 7, param, channel)
        be, fe = np.asarray(be), np.asarray(fe)
        diff = int(np.sum((be != rb) | (fe != rf)))
        log(f"[2] viterbi kernel {code.name} {channel} B={B}: bit errors "
            f"{int(be.sum())} vs replica {int(rb.sum())}, frame errors "
            f"{int(fe.sum())} vs {int(rf.sum())}, lanes differing {diff}")
        if diff:
            raise AssertionError(f"viterbi kernel {code.name}: {diff} lanes "
                                 "differ from the XLA replica")
        kern = jax.jit(lambda s: vm.mc_chain_viterbi(
            code, B, nsteps, s, param, channel)[0].sum())
        cold, t_k = warm_time(kern, [(jnp.int32(100 + i),) for i in range(4)])
        step = make_point_step(code, channel, "viterbi", "soft", frames=B)
        xla = jax.jit(lambda k: step(k, param)[0])
        cold_x, t_x = warm_time(
            xla, [(jax.random.PRNGKey(200 + i),) for i in range(4)])
        rate_k = B * nsteps * L / t_k
        rate_x = B * L / t_x
        log(f"[2] viterbi kernel {code.name} B={B}: kernel "
            f"{t_k / nsteps * 1e3:.3f} ms/step ({rate_k:.4e} info bits/s, "
            f"compile+first {cold:.1f} s); XLA chain {t_x * 1e3:.3f} ms/step "
            f"({rate_x:.4e} info bits/s); kernel/XLA {rate_k / rate_x:.2f}x")

    # overlap-save windows of unterminated streams (the long-frame cells)
    code = get_code("k3-75")
    lanes, window, warmup = 1 << 14, 1920, 128
    be, _ = vm.mc_longframe_viterbi(code, lanes, 1, 5, 0.0125, "bsc",
                                    window=window, warmup=warmup)
    rep = vm.window_replica(code, lanes, "bsc", "soft", window, warmup, 0)
    rb = np.asarray(rep(jnp.int32(5), jnp.float32(0.0125)))
    diff = int(np.sum(np.asarray(be) != rb))
    log(f"[2] window kernel k3-75 bsc lanes={lanes}: bit errors "
        f"{int(np.asarray(be).sum())} vs replica {int(rb.sum())}, lanes "
        f"differing {diff}")
    if diff:
        raise AssertionError("window kernel differs from the XLA replica")
    kern = jax.jit(lambda s: vm.mc_longframe_viterbi(
        code, lanes, 1, s, 0.0125, "bsc", window=window,
        warmup=warmup)[0].sum())
    _, t_k = warm_time(kern, [(jnp.int32(300 + i),) for i in range(4)])
    _, t_x = warm_time(lambda s: rep(s, jnp.float32(0.0125)).sum(),
                       [(jnp.int32(400 + i),) for i in range(4)])
    bits = lanes * window
    log(f"[2] window kernel k3-75 lanes={lanes} window={window}: kernel "
        f"{t_k * 1e3:.3f} ms ({bits / t_k:.4e} info bits/s); XLA replica "
        f"{t_x * 1e3:.3f} ms ({bits / t_x:.4e} info bits/s); kernel/XLA "
        f"{t_x / t_k:.2f}x")


def phase_sequential_kernel(jax, jnp, np):
    from convolutional_codes.models.codebook import get_code
    from convolutional_codes.ops import sequential_mc as sm
    from convolutional_codes.ops.channels import awgn_sigma
    from convolutional_codes.ops.fano import fano_decode_soft
    from convolutional_codes.ops.mc_datagen import frames_host
    from convolutional_codes.ops.stack import stack_decode_soft

    code = get_code(0)
    ref = {"stack": lambda d: stack_decode_soft(code, d),
           "fano": lambda d: fano_decode_soft(code, d)}
    # 3 dB: deep searches and timeout-bound Fano frames among the 4096
    N = 4096
    _, syms = frames_host(code, np.arange(N), 42, float(awgn_sigma(3.0)),
                          "awgn")
    syms = jnp.asarray(syms)
    for dec in ("stack", "fano"):
        a = np.asarray(jax.jit(lambda d: sm.sequential_decode(dec, code, d))(
            syms))
        b = np.asarray(jax.jit(ref[dec])(syms))
        nd = int(np.sum(np.any(a != b, axis=1)))
        log(f"[2] {dec} kernel vs ops/{dec}.py on {N} frames at 3 dB: "
            f"frames differing {nd}")
        if nd:
            raise AssertionError(f"{dec} kernel differs from the XLA machine")

    # warm decode times on fresh frames at 8 dB, kernel vs XLA machine
    N = 16384
    sets = [(jnp.asarray(frames_host(code, np.arange(N) + i * N, 50 + i,
                                     float(awgn_sigma(8.0)), "awgn")[1]),)
            for i in range(3)]
    for dec in ("stack", "fano"):
        _, t_k = warm_time(jax.jit(
            lambda d: sm.sequential_decode(dec, code, d)), sets)
        _, t_x = warm_time(jax.jit(ref[dec]), sets)
        bits = N * code.block_length
        log(f"[2] {dec} decode {N} frames at 8 dB: kernel {t_k * 1e3:.2f} ms"
            f" ({bits / t_k:.4e} info bits/s); XLA machine "
            f"{t_x * 1e3:.2f} ms ({bits / t_x:.4e} info bits/s); "
            f"kernel/XLA {t_x / t_k:.2f}x")

    # one committed sweep row each, rerun from its frame-id plan: lanes,
    # frames per lane and the cold/warm seed split of sim/sweep.run_sweep,
    # with the seed tools/reproduce_curves.py sweeps use (1234) and the
    # point's index in its grid
    rows = [
        ("stack", get_code(0), "results/awgn_stack_soft_0.jsonl", 8.0, 4),
        ("fano", get_code("k15-r14-16qam"), "results/awgn_fano_16qam.jsonl",
         6.0, 4),
    ]
    for dec, c, path, point, idx in rows:
        with open(os.path.join(ROOT, path)) as f:
            rec = next(r for r in map(json.loads, f) if r["point"] == point)
        lanes = 8192
        fpl = rec["bits"] // (lanes * c.block_length)
        seed = (1234 * 1000003 + idx * 7919) & 0x7FFFFFFF
        param = float(awgn_sigma(point))
        t0 = time.perf_counter()
        b1, f1, _ = sm.mc_sequential(dec, c, lanes, 1, seed, param)
        b2, f2, _ = sm.mc_sequential(dec, c, lanes, fpl - 1,
                                     seed ^ 0x2A5A5A5A, param)
        wall = time.perf_counter() - t0
        got = (b1 + b2, f1 + f2)
        want = (rec["bit_errors"], rec["frame_errors"])
        log(f"[2] rerun {path} point={point:g} ({lanes}x{fpl} frames, "
            f"{wall:.1f} s): counters {got}, committed {want}, "
            f"{'reproduced bit-for-bit' if got == want else 'NOT reproduced'}")


def phase_decode(jax, jnp, np):
    from convolutional_codes.models.codebook import get_code
    from convolutional_codes.ops.channels import awgn, awgn_sigma
    from convolutional_codes.ops.demapper import soft_demap
    from convolutional_codes.ops.encoder import encode_stream
    from convolutional_codes.ops.mapper import map_symbols
    from convolutional_codes.parallel.mesh import make_mesh
    from convolutional_codes.parallel.streaming import (
        monolithic_reference_decode, streaming_viterbi_decode)

    code = get_code("nasa-k7")
    B, T = 128, 65536
    L = T - (code.constraint_length - 1)
    kb, kn = jax.random.split(jax.random.PRNGKey(9))
    bits = jax.random.bernoulli(kb, 0.5, (B, L)).astype(jnp.int32)
    rx = awgn(kn, map_symbols(code, encode_stream(code, bits, terminate=True)),
              awgn_sigma(3.0))
    dists = soft_demap(code.symlen_out, rx)
    mesh = make_mesh({"seq": 1}, devices=jax.devices()[:1])
    t0 = time.perf_counter()
    out = np.asarray(streaming_viterbi_decode(code, dists, mesh))
    t_s = time.perf_counter() - t0
    mono = np.asarray(jax.jit(
        lambda d: monolithic_reference_decode(code, d))(dists))
    nd = int(np.sum(out != mono))
    ber = float(np.mean(out[:, :L] != np.asarray(bits)))
    log(f"[3] streaming_viterbi_decode nasa-k7 B={B} T={T}: bits differing "
        f"from monolithic_reference_decode {nd}; BER {ber:.3e}; first call "
        f"{t_s:.1f} s")
    if nd:
        raise AssertionError("streaming decode differs from the monolithic one")


def phase_four_cards(jax, jnp, np, B=1 << 20, nsteps=16, lanes=8192, fpl=32):
    from convolutional_codes.models.codebook import get_code
    from convolutional_codes.ops.channels import awgn_sigma
    from convolutional_codes.ops.sequential_mc import mc_stack
    from convolutional_codes.parallel.mesh import make_mesh
    from convolutional_codes.parallel.montecarlo import (
        _fused_runner, fused_grid_accumulate)
    from convolutional_codes.parallel.seq_grid import seq_mc_grid

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 GPUs, found "
                           f"{len(jax.devices())}")
    code = get_code(0)
    mesh = make_mesh({"sweep": 2, "frames": 2}, devices=jax.devices()[:4])
    params = [float(awgn_sigma(4.0)), float(awgn_sigma(6.0))]
    seeds = np.array([[11, 12], [13, 14]], np.int32)
    fused_grid_accumulate(code, 1, seeds, params, B, mesh)       # compile
    t0 = time.perf_counter()
    grid = fused_grid_accumulate(code, nsteps, seeds, params, B, mesh)
    t4 = time.perf_counter() - t0
    one = _fused_runner(code, B, None, "awgn")
    jax.block_until_ready(one(jnp.int32(1), jnp.float32(params[0]),
                              jnp.int32(1)))
    t0 = time.perf_counter()
    serial = []
    for r in range(2):
        tot = np.zeros(3, np.int64)
        for d in range(2):
            tot += np.asarray([int(x) for x in one(
                jnp.int32(seeds[r, d]), jnp.float32(params[r]),
                jnp.int32(nsteps))])
        serial.append(tot)
    t1 = time.perf_counter() - t0
    for r in range(2):
        g = (int(grid[0][r]), int(grid[1][r]), int(grid[2][r]))
        log(f"[4] viterbi grid point {r}: 4 cards {g}, 1 card "
            f"{tuple(int(x) for x in serial[r])}")
        if g != tuple(int(x) for x in serial[r]):
            raise AssertionError("viterbi grid differs from the serial run")
    log(f"[4] viterbi grid wall: 4 cards {t4:.3f} s, 1 card {t1:.3f} s "
        f"({t1 / t4:.2f}x)")

    sp = [float(awgn_sigma(4.0)), float(awgn_sigma(6.0))]
    seq_mc_grid("stack", code, lanes, 1, [21, 22], sp, mesh)       # compile
    t0 = time.perf_counter()
    be, fe, nb = seq_mc_grid("stack", code, lanes, fpl, [21, 22], sp, mesh)
    t4 = time.perf_counter() - t0
    mc_stack(code, lanes, 1, 21, sp[0])                             # compile
    t0 = time.perf_counter()
    serial = [mc_stack(code, lanes, fpl, s, p) for s, p in zip([21, 22], sp)]
    t1 = time.perf_counter() - t0
    for r in range(2):
        g = (int(be[r]), int(fe[r]), int(nb[r]))
        log(f"[4] stack seq_mc_grid point {r}: 4 cards {g}, 1 card "
            f"{serial[r]}")
        if g != serial[r]:
            raise AssertionError("seq_mc_grid differs from the serial run")
    log(f"[4] stack grid wall: 4 cards {t4:.3f} s, 1 card {t1:.3f} s "
        f"({t1 / t4:.2f}x)")


def main(argv) -> int:
    four = "--four-cards" in argv
    import jax
    if jax.devices()[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {jax.devices()[0].platform}); "
              "this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp
    import numpy as np

    phase_device(jax)
    if four:
        phases = [(4, lambda: phase_four_cards(jax, jnp, np))]
    else:
        phases = [(1, phase_sweep),
                  (2, lambda: phase_viterbi_kernel(jax, jnp, np)),
                  (2, lambda: phase_sequential_kernel(jax, jnp, np)),
                  (3, lambda: phase_decode(jax, jnp, np))]
    for n, phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"[{n}] phase wall {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
