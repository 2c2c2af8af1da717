"""Sweep harness: statistical BER checks, mesh sharding, resume, output."""

import json
import os

import jax
import numpy as np
import pytest

from convolutional_codes.parallel.mesh import make_mesh
from convolutional_codes.parallel.montecarlo import sweep_grid_accumulate
from convolutional_codes.sim.chain import make_point_step
from convolutional_codes.sim.sweep import (
    SweepSpec, run_sweep, awgn_tier_bits, bsc_tier_bits)
from convolutional_codes.utils.records import octave_rows, write_jsonl


def binomial_ok(errors, bits, p_expected, z=4.0, frame_errors=0):
    """|observed - expected| within z sigma of the binomial count.

    Decoded-BER checks pass ``frame_errors``: decoder bit errors arrive
    in per-frame bursts (~6-14 bits/event for these points), so the
    binomial variance is inflated by the bits-per-event cluster factor
    (the same model as tools/reproduce_curves.py).  The raw-binomial form
    remains for memoryless channels (uncoded, channel-level checks)."""
    cluster = max(1.0, errors / frame_errors) if frame_errors else 1.0
    sigma = np.sqrt(cluster * bits * p_expected * (1 - p_expected))
    return abs(errors - bits * p_expected) <= z * sigma + 1


def test_tiering_matches_reference():
    assert awgn_tier_bits(0.0) == 8e5 and awgn_tier_bits(4.0) == 8e5
    assert awgn_tier_bits(6.0) == 8e6
    assert awgn_tier_bits(8.0) == 8e7 and awgn_tier_bits(10.0) == 8e7
    assert awgn_tier_bits(12.0) == 8e8
    assert bsc_tier_bits(0.0125) == 8e8
    assert bsc_tier_bits(0.05) == 8e7
    assert bsc_tier_bits(0.2) == 8e6
    assert bsc_tier_bits(0.4) == 8e5


def test_bsc_golden_point_statistical():
    """Code 0 hard Viterbi at p=0.0125 → published BER 9.545e-3
    (results/binary_symmetric_channel.m:5)."""
    spec = SweepSpec(code=0, channel="bsc", decoder="viterbi",
                     points=[0.0125], frames_per_step=2048,
                     bits_per_point=2e6, seed=123)
    (r,) = run_sweep(spec, verbose=False)
    assert binomial_ok(r.bit_errors, r.bits, 9.545e-3,
                       frame_errors=r.frame_errors), r.ber


def test_uncoded_qpsk_closed_form():
    """Uncoded QPSK at 4 dB: published 1.2494e-2 (awgn_channel.m:5),
    closed form Q(sqrt(2*Eb/N0)) = 1.25e-2."""
    spec = SweepSpec(code=0, channel="uncoded", points=[4.0],
                     frames_per_step=1 << 15, bits_per_point=2e6, seed=5)
    (r,) = run_sweep(spec, verbose=False)
    assert binomial_ok(r.bit_errors, r.bits, 1.2494e-2), r.ber


def test_sharded_sweep_matches_unsharded_scale():
    """psum-aggregated counters over an 8-device frames mesh simulate 8x the
    bits and stay statistically consistent."""
    mesh = make_mesh({"frames": 8})
    spec = SweepSpec(code=0, channel="bsc", decoder="viterbi",
                     points=[0.05], frames_per_step=256,
                     bits_per_point=8 * 256 * 40 * 4, seed=7)
    (r,) = run_sweep(spec, mesh=mesh, verbose=False)
    assert r.bits == 8 * 256 * 40 * 4
    assert binomial_ok(r.bit_errors, r.bits, 0.1208,
                       frame_errors=r.frame_errors)


def test_sweep_grid_two_axis_mesh():
    mesh = make_mesh({"sweep": 2, "frames": 4})
    code_step = make_point_step(
        __import__("convolutional_codes").get_code(0),
        "bsc", "viterbi", "soft", frames=128)
    params = np.array([0.0125, 0.05], np.float32)
    be, fe, nb = sweep_grid_accumulate(code_step, 2, jax.random.PRNGKey(0),
                                       params, mesh)
    be, nb = np.asarray(be), np.asarray(nb)
    assert be.shape == (2,) and np.all(nb == 128 * 40 * 2 * 4)
    assert be[1] > be[0]  # worse channel, more errors


def test_checkpoint_resume(tmp_path):
    ck = str(tmp_path / "ck.json")
    spec = SweepSpec(code=0, channel="bsc", decoder="viterbi",
                     points=[0.05, 0.1], frames_per_step=128,
                     bits_per_point=128 * 40 * 2, seed=9)
    first = run_sweep(spec, checkpoint_path=ck, verbose=False)
    with open(ck) as f:
        payload = json.load(f)
    assert len(payload) == 3 and "__spec__" in payload  # 2 points + spec hash
    second = run_sweep(spec, checkpoint_path=ck, verbose=False)
    assert [r.to_dict() for r in first] == [r.to_dict() for r in second]


def test_checkpoint_spec_mismatch_refused(tmp_path):
    """Resuming from a checkpoint written by a different spec must raise:
    per-point resume silently skips matching points, so a stale checkpoint
    would quietly keep old counters."""
    import pytest

    ck = str(tmp_path / "ck.json")
    spec = SweepSpec(code=0, channel="bsc", decoder="viterbi",
                     points=[0.05], frames_per_step=128,
                     bits_per_point=128 * 40, seed=9)
    run_sweep(spec, checkpoint_path=ck, verbose=False)
    # different seed → different counters → must refuse
    other = SweepSpec(code=0, channel="bsc", decoder="viterbi",
                      points=[0.05], frames_per_step=128,
                      bits_per_point=128 * 40, seed=10)
    with pytest.raises(ValueError, match="different .*spec"):
        run_sweep(other, checkpoint_path=ck, verbose=False)
    # legacy checkpoint without a fingerprint is refused too
    with open(ck) as f:
        payload = json.load(f)
    del payload["__spec__"]
    with open(ck, "w") as f:
        json.dump(payload, f)
    with pytest.raises(ValueError, match="different .*spec"):
        run_sweep(spec, checkpoint_path=ck, verbose=False)


def test_records_output(tmp_path):
    spec = SweepSpec(code=0, channel="bsc", decoder="viterbi",
                     points=[0.1], frames_per_step=128,
                     bits_per_point=128 * 40, seed=1)
    recs = run_sweep(spec, verbose=False)
    out = octave_rows(recs, "test_var")
    assert "test_var = [" in out and "x_test_var = [0.1]" in out
    p = str(tmp_path / "r.jsonl")
    write_jsonl(recs, p)
    row = json.loads(open(p).read().splitlines()[0])
    assert row["channel"] == "bsc" and row["bits"] == 128 * 40
    # read_jsonl round-trips the typed records (shared by the tools)
    from convolutional_codes.sim.sweep import PointRecord
    from convolutional_codes.utils.records import read_jsonl
    assert read_jsonl(p, PointRecord) == recs
    assert read_jsonl(p)[0]["bits"] == 128 * 40


def test_cli_end_to_end(tmp_path, capsys):
    from convolutional_codes.sim.cli import main
    oct_path = str(tmp_path / "o.m")
    rc = main(["bsc", "--code", "0", "--points", "0.1", "--frames", "64",
               "--bits-per-point", "2560", "--octave", oct_path])
    assert rc == 0
    assert os.path.exists(oct_path)


def test_run_sweep_grid_matches_serial():
    """run_sweep over a sweep×frames mesh (equal-tier points grouped onto
    the sweep axis) produces COUNTER-IDENTICAL records to the frames-only
    serial path — the grid path derives every per-(point, chunk, device)
    key exactly as the serial path does."""
    from convolutional_codes.ops.channels import awgn_sigma  # noqa: F401

    pts = (4.0, 6.0, 8.0, 10.0)
    spec = SweepSpec(code=0, channel="awgn", decoder="viterbi",
                     points=pts, frames_per_step=64,
                     bits_per_point=4 * 64 * 40 * 3, seed=3)
    grid = run_sweep(spec, mesh=make_mesh({"sweep": 2, "frames": 4}),
                     verbose=False)
    serial = run_sweep(spec, mesh=make_mesh({"frames": 4},
                                        devices=jax.devices()[:4]),
                   verbose=False)
    assert len(grid) == len(serial) == len(pts)
    for g, s in zip(grid, serial):
        assert (g.point, g.bits, g.bit_errors, g.frame_errors) == \
               (s.point, s.bits, s.bit_errors, s.frame_errors), (g, s)


def test_run_sweep_grid_leftovers_mixed_tiers():
    """Odd group sizes: grid batches cover floor(len/Ds)*Ds points per
    tier, the rest run serially — records still counter-match the serial
    sweep and arrive in point order."""
    spec = SweepSpec(code=0, channel="bsc", decoder="viterbi",
                     points=(0.0125, 0.05, 0.1), frames_per_step=64,
                     seed=5, base_bits=64 * 40 * 4 * 10)
    grid = run_sweep(spec, mesh=make_mesh({"sweep": 2, "frames": 4}),
                     verbose=False)
    serial = run_sweep(spec, mesh=make_mesh({"frames": 4},
                                        devices=jax.devices()[:4]),
                   verbose=False)
    assert [r.point for r in grid] == [0.0125, 0.05, 0.1]
    for g, s in zip(grid, serial):
        assert (g.bits, g.bit_errors, g.frame_errors) == \
               (s.bits, s.bit_errors, s.frame_errors), (g, s)


def test_seq_mc_grid_routing_plan(monkeypatch):
    """run_sweep's mesh grouping for sequential MC points: equal-plan
    points batch onto device groups with the SAME per-point seeds the
    serial leg derives, a leftover point still uses the whole mesh
    (R=1), and plans that cannot split evenly fall back to the serial
    leg instead of raising (counter identity itself is proven in
    tests/test_seq_grid.py on the real kernels)."""
    from convolutional_codes.parallel import seq_grid as sg
    from convolutional_codes.sim import sweep as sw

    L = 40
    grid_calls = []
    serial_calls = []

    def fake_grid(decoder, code, lanes, fpl, seeds, params, mesh, **kw):
        grid_calls.append((lanes, fpl, tuple(seeds), len(params)))
        R = len(seeds)
        return (np.zeros(R, np.int64), np.zeros(R, np.int64),
                np.full(R, lanes * fpl * L, np.int64))

    def fake_mc(code, lanes, fpl, seed, param, **kw):
        serial_calls.append((lanes, fpl, seed))
        return 0, 0, lanes * fpl * L

    monkeypatch.setattr(sg, "seq_mc_grid", fake_grid)
    monkeypatch.setattr(
        "convolutional_codes.ops.sequential_mc.mc_stack", fake_mc)
    monkeypatch.setattr(sw, "current_platform", lambda: "gpu")

    # 3 equal-tier points on an 8-device mesh -> one R=2 batch + one R=1
    spec = SweepSpec(code=0, channel="awgn", decoder="stack",
                     points=(6.0, 8.0, 10.0),
                     bits_per_point=2 * 1024 * L, seed=5)
    mesh = make_mesh({"frames": 8})
    recs = run_sweep(spec, mesh=mesh, verbose=False)
    # cold fpl=1 + warm fpl-1 per batch
    assert [c[:2] for c in grid_calls] == [(1024, 1)] * 2 + [(1024, 1)] * 2
    exp = [(5 * 1000003 + i * 7919) & 0x7FFFFFFF for i in range(3)]
    assert grid_calls[0][2] == (exp[0], exp[1])
    assert grid_calls[1][2] == tuple(s ^ 0x2A5A5A5A for s in exp[:2])
    assert grid_calls[2][2] == (exp[2],)
    assert not serial_calls
    assert all(r.bits == 2 * 1024 * L for r in recs)

    # 5 devices cannot split 1024 lanes for a single point (dpp=5): the
    # point falls back to the serial leg
    grid_calls.clear()
    spec5 = SweepSpec(code=0, channel="awgn", decoder="stack",
                      points=(8.0,), bits_per_point=1024 * L, seed=5)
    mesh5 = make_mesh({"frames": 5}, devices=jax.devices()[:5])
    run_sweep(spec5, mesh=mesh5, verbose=False)
    assert not grid_calls
    assert [c[:2] for c in serial_calls] == [(1024, 1)]
