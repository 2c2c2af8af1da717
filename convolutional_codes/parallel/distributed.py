"""Multi-host initialization and scaling measurement.

The reference is a single process with no distributed story (SURVEY.md §2e);
the framework's north star asks for decoded-bits/s scaling at 1 chip /
1 host / N hosts.  This module provides the process-level entry point:

  * :func:`initialize_from_env` — a real ``jax.distributed.initialize``
    code path driven by the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``), so a launcher only has to
    export three variables per process.  After it returns,
    ``jax.devices()`` spans every host and
    :func:`convolutional_codes.parallel.mesh.make_mesh` lays the
    ``sweep``/``frames`` axes over it.
  * :func:`measure_scaling` — weak-scaling efficiency harness: runs the
    same per-device workload on 1..N-device ``frames`` meshes and reports
    decoded-bits/s plus efficiency vs the single-device rate.  BER counter
    aggregation is a psum, so throughput is the only thing that can degrade.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

import jax

from convolutional_codes.parallel.mesh import make_mesh


def initialize_from_env(verbose: bool = True) -> bool:
    """Initialize multi-host JAX when the environment asks for it.

    Returns True when ``jax.distributed.initialize`` ran.  No-ops (returns
    False) in single-process runs: when none of the env vars are set,
    nothing happens, so it is always safe to call this first thing in a
    program.
    """
    env = {name: os.environ.get(name)
           for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
                        "JAX_PROCESS_ID")}
    coord, nproc, pid = env.values()
    if any(env.values()) and not all(env.values()):
        missing = [k for k, v in env.items() if not v]
        raise ValueError(
            f"partial multi-host environment: {missing} unset while "
            f"{[k for k, v in env.items() if v]} set — a silent "
            f"single-process fallback here would deadlock the other "
            f"processes at their first collective")
    if coord and nproc and pid:
        jax.distributed.initialize(coordinator_address=coord,
                                   num_processes=int(nproc),
                                   process_id=int(pid))
    else:
        return False
    if verbose:
        print(f"jax.distributed: process {jax.process_index()}/"
              f"{jax.process_count()}, {jax.local_device_count()} local / "
              f"{jax.device_count()} global devices", flush=True)
    return True


@dataclass
class ScalingPoint:
    devices: int
    bits: int
    wall_s: float
    bits_per_s: float
    efficiency: float       # vs single-device bits/s (weak scaling)


def measure_scaling(code=None, frames_per_device: int = 512, nsteps: int = 4,
                    snr_db: float = 8.0, device_counts: Optional[List[int]] = None,
                    repeats: int = 3) -> List[ScalingPoint]:
    """Weak-scaling measurement of the sharded Monte-Carlo Viterbi chain.

    Each device simulates ``frames_per_device * nsteps`` frames per run; a
    perfectly scaling system yields constant wall time as devices grow.
    Runs on whatever backend is active (virtual CPU mesh via
    ``--xla_force_host_platform_device_count`` or a real slice).
    """
    import jax.numpy as jnp

    from convolutional_codes.models.codebook import get_code
    from convolutional_codes.ops.channels import awgn_sigma
    from convolutional_codes.parallel.montecarlo import sharded_accumulate
    from convolutional_codes.sim.chain import make_point_step

    code = code if code is not None else get_code(0)
    ndev = jax.device_count()
    counts = device_counts or [d for d in (1, 2, 4, 8, 16, 32) if d <= ndev]
    step = make_point_step(code, "awgn", "viterbi", "soft", frames_per_device)
    sigma = float(awgn_sigma(snr_db))
    out: List[ScalingPoint] = []
    for d in counts:
        mesh = make_mesh({"frames": d}, devices=jax.devices()[:d])
        key = jax.random.PRNGKey(d)
        # warmup (compile)
        sharded_accumulate(step, nsteps, key, sigma, mesh)
        best = float("inf")
        bits = 0
        for r in range(repeats):
            t0 = time.time()
            _, _, nb = sharded_accumulate(
                step, nsteps, jax.random.fold_in(key, r + 1), sigma, mesh)
            best = min(best, time.time() - t0)
            bits = nb
        rate = bits / best
        # efficiency vs the first point's PER-DEVICE rate (the first
        # measured count need not be 1)
        eff = (rate / (out[0].bits_per_s / out[0].devices * d)
               if out else 1.0)
        out.append(ScalingPoint(d, bits, best, rate, eff))
    return out


def main() -> None:
    initialize_from_env()
    pts = measure_scaling()
    print(f"{'devices':>8} {'bits':>12} {'wall_s':>9} "
          f"{'bits/s':>12} {'efficiency':>10}")
    for p in pts:
        print(f"{p.devices:>8} {p.bits:>12} {p.wall_s:>9.4f} "
              f"{p.bits_per_s:>12.4g} {p.efficiency:>10.3f}")


if __name__ == "__main__":
    main()
