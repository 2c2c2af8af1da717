"""Multi-host entry point + scaling harness (parallel/distributed.py)."""

import jax
import numpy as np

from convolutional_codes.parallel.distributed import (
    initialize_from_env, measure_scaling)


def test_initialize_noop_without_env(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "JAX_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(k, raising=False)
    assert initialize_from_env() is False


def test_scaling_harness_runs():
    pts = measure_scaling(frames_per_device=32, nsteps=1,
                          device_counts=[1, min(2, jax.device_count())],
                          repeats=1)
    assert pts[0].devices == 1 and pts[0].efficiency == 1.0
    for p in pts:
        assert p.bits == p.devices * 32 * 40      # code 0 block_len
        assert np.isfinite(p.bits_per_s) and p.bits_per_s > 0


def test_initialize_partial_env_raises(monkeypatch):
    """A partially-set multi-host environment must fail loudly: a silent
    single-process fallback would leave the other processes deadlocked at
    their first collective."""
    import pytest

    monkeypatch.delenv("JAX_AUTO_DISTRIBUTED", raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1234")
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="JAX_NUM_PROCESSES"):
        initialize_from_env()


def test_scaling_efficiency_baseline_not_device1():
    """Efficiency is defined vs the first point's PER-DEVICE rate, so a
    measurement starting at 2 devices reports ~1.0 at its own baseline,
    not ~0.5 (regression)."""
    if jax.device_count() < 4:
        import pytest
        pytest.skip("needs 4 devices")
    pts = measure_scaling(frames_per_device=32, nsteps=1,
                          device_counts=[2, 4], repeats=1)
    assert pts[0].devices == 2 and pts[0].efficiency == 1.0
    expected = pts[1].bits_per_s / (pts[0].bits_per_s / 2 * 4)
    assert abs(pts[1].efficiency - expected) < 1e-9
    assert pts[1].efficiency > 0


def test_dryrun_multichip_virtual_devices():
    """The multi-device dry run (sweep x frames grid, fused and sequential
    kernels under shard_map, streaming) on 8 virtual CPU devices."""
    import __graft_entry__ as g

    g.dryrun_multichip(8, interpret=True)
