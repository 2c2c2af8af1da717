"""Sharded on-device Monte-Carlo accumulation.

The reference runs one block at a time in a host loop and accumulates error
counters in C variables (``AWGN-channel/main.c:212-233``).  Here the whole
accumulation lives on device: a ``lax.scan`` over steps (one compiled
program, no per-step dispatch), optionally wrapped in ``shard_map`` over the
``frames`` mesh axis with a ``psum`` reduction of the counters, and over the
``sweep`` axis with per-group channel parameters.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from convolutional_codes.models.constellations import register_dependent_cache

#: (key, param) -> (bit_errors, frame_errors, bits) — see sim.chain.StepFn.
StepFn = Callable


def _scan_steps(step: StepFn, nsteps: int):
    """(key, param) → summed (bit_errors, frame_errors, bits) over nsteps."""

    def run(key, param):
        def body(carry, i):
            be, fe, nb = step(jax.random.fold_in(key, i), param)
            return (carry[0] + be, carry[1] + fe, carry[2] + nb), None

        init = (jnp.int32(0), jnp.int32(0), jnp.int32(0))
        # xs as a host numpy constant: a jnp.arange here would be a
        # committed device array embedded at lowering time
        out, _ = jax.lax.scan(body, init, np.arange(nsteps, dtype=np.int32))
        return out

    return run


@partial(jax.jit, static_argnums=(0, 1))
def _accumulate_single(step: StepFn, nsteps: int, key, param):
    return _scan_steps(step, nsteps)(key, param)


@lru_cache(maxsize=None)
def _sharded_runner(step: StepFn, nsteps: int, mesh: Mesh):
    fa = "frames"

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P(fa), P()), out_specs=P(), check_vma=False)
    def run(local_keys, p):
        be, fe, nb = _scan_steps(step, nsteps)(local_keys[0], p)
        return tuple(jax.lax.psum(x, fa) for x in (be, fe, nb))

    return run


def sharded_accumulate(step: StepFn, nsteps: int, key: jax.Array, param,
                       mesh: Optional[Mesh] = None) -> Tuple[int, int, int]:
    """Run ``nsteps`` accumulation steps of ``step`` at one sweep point.

    Without a mesh: single-device scan.  With a mesh containing a ``frames``
    axis: every device along it runs ``nsteps`` with an independent key and
    the counters are psum-reduced, so total simulated bits scale with the
    axis size.  Returns Python ints.
    """
    if mesh is None or "frames" not in mesh.axis_names:
        be, fe, nb = _accumulate_single(step, nsteps, key, param)
        return int(be), int(fe), int(nb)

    keys = jax.random.split(key, mesh.shape["frames"])
    run = _sharded_runner(step, nsteps, mesh)
    be, fe, nb = run(keys, jnp.asarray(param, jnp.float32))
    return int(be), int(fe), int(nb)


@lru_cache(maxsize=None)
def _grid_runner(step: StepFn, nsteps: int, mesh: Mesh):
    sa, fa = "sweep", "frames"

    @jax.jit
    @partial(shard_map, mesh=mesh,
             in_specs=(P(sa, fa), P(sa)), out_specs=P(sa),
             check_vma=False)
    def run(local_keys, local_params):
        def per_point(k, p):
            return _scan_steps(step, nsteps)(k, p)

        be, fe, nb = jax.vmap(per_point)(local_keys[:, 0], local_params)
        return (jax.lax.psum(be, fa), jax.lax.psum(fe, fa),
                jax.lax.psum(nb, fa))

    return run


def sweep_grid_accumulate(step: StepFn, nsteps: int, key: jax.Array,
                          params: jnp.ndarray, mesh: Mesh) -> Tuple[jnp.ndarray, ...]:
    """2-D sharding: points split over the ``sweep`` axis, frames over
    ``frames``.  ``params``: [R] channel parameters, R divisible by the sweep
    axis size.  Returns per-point (bit_errors, frame_errors, bits) arrays [R].
    """
    sa, fa = "sweep", "frames"
    assert sa in mesh.axis_names and fa in mesh.axis_names
    R = params.shape[0]
    keys = jax.random.split(key, R * mesh.shape[fa])
    keys = keys.reshape(R, mesh.shape[fa], *keys.shape[1:])
    return _grid_runner(step, nsteps, mesh)(keys,
                                            jnp.asarray(params, jnp.float32))


def grid_accumulate_with_keys(step: StepFn, nsteps: int, keys: jnp.ndarray,
                              params, mesh: Mesh) -> Tuple[jnp.ndarray, ...]:
    """:func:`sweep_grid_accumulate` with caller-provided per-point keys
    ``[R, frames_axis, 2]`` — ``run_sweep`` passes the exact keys its
    serial path would use for each point, so grouped (sweep×frames) and
    serial sweeps produce **identical counters**, not just identical
    statistics (validated by tests/test_sweep.py)."""
    return _grid_runner(step, nsteps, mesh)(
        keys, jnp.asarray(params, jnp.float32))


# ---------------------------------------------------------------------------
# Fused-kernel path: the whole Viterbi Monte-Carlo chain in one kernel
# ---------------------------------------------------------------------------

def _fused_counts(code, batch: int, channel: str, demapper: str,
                  interpret: bool):
    from convolutional_codes.ops.viterbi_mc import mc_chain_viterbi

    L = code.block_length

    def counts(seed, param, nsteps):
        be, fe = mc_chain_viterbi(code, batch, nsteps, seed, param, channel,
                                  demapper=demapper, interpret=interpret)
        return (be.sum(dtype=jnp.int32), fe.sum(dtype=jnp.int32),
                jnp.int32(batch * L) * nsteps)

    return counts


@lru_cache(maxsize=None)
def _fused_runner(code, batch: int, mesh: Optional[Mesh], channel: str,
                  demapper: str = "soft", interpret: bool = False):
    counts = _fused_counts(code, batch, channel, demapper, interpret)
    if mesh is None or "frames" not in mesh.axis_names:
        return jax.jit(counts)

    fa = "frames"

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(fa), P(), P()), out_specs=P(),
             check_vma=False)
    def run(seeds, sigma, nsteps):
        out = counts(seeds[0], sigma, nsteps)
        return tuple(jax.lax.psum(x, fa) for x in out)

    return run


# fused kernels embed the constellation table of code.symlen_out
register_dependent_cache(_fused_runner.cache_clear)


@lru_cache(maxsize=None)
def _fused_grid_runner(code, batch: int, mesh: Mesh, channel: str,
                       demapper: str, interpret: bool):
    counts = _fused_counts(code, batch, channel, demapper, interpret)
    sa, fa = "sweep", "frames"

    @jax.jit
    @partial(shard_map, mesh=mesh, in_specs=(P(sa, fa), P(sa), P()),
             out_specs=P(sa), check_vma=False)
    def run(seeds, params, nsteps):
        # one sweep point per sweep-axis group (local R == 1), so the
        # kernel call needs no vmap; devices along `frames` psum-reduce
        be, fe, nb = counts(seeds[0, 0], params[0], nsteps)
        return tuple(jax.lax.psum(x, fa)[None] for x in (be, fe, nb))

    return run


register_dependent_cache(_fused_grid_runner.cache_clear)


def fused_grid_accumulate(code, nsteps: int, seeds_2d, params, batch: int,
                          mesh: Mesh, channel: str = "awgn",
                          demapper: str = "soft", interpret: bool = False):
    """Fused-kernel sweep×frames accumulation: ``seeds_2d`` [R, frames_axis]
    int32 per-(point, device) seeds with R == the sweep axis size, ``params``
    [R].  Counter-identical to R separate :func:`fused_mc_accumulate` calls
    with the same seeds (validated by tests/test_sweep.py)."""
    run = _fused_grid_runner(code, batch, mesh, channel, demapper, interpret)
    be, fe, nb = run(jnp.asarray(seeds_2d, jnp.int32),
                     jnp.asarray(params, jnp.float32), jnp.int32(nsteps))
    return np.asarray(be), np.asarray(fe), np.asarray(nb)


def fused_mc_accumulate(code, nsteps: int, seed: int, param, batch: int,
                        mesh: Optional[Mesh] = None, channel: str = "awgn",
                        demapper: str = "soft",
                        interpret: bool = False) -> Tuple[int, int, int]:
    """Fused-kernel equivalent of :func:`sharded_accumulate` for the
    Viterbi chains.  ``seed`` is a Python int; per-device streams are
    derived from it on the frames axis.  ``interpret`` runs the kernel in
    the Pallas interpreter (tests on the CPU)."""
    run = _fused_runner(code, batch, mesh, channel, demapper, interpret)
    if mesh is None or "frames" not in mesh.axis_names:
        be, fe, nb = run(jnp.int32(seed & 0x7FFFFFFF),
                         jnp.float32(param), jnp.int32(nsteps))
        return int(be), int(fe), int(nb)
    ndev = mesh.shape["frames"]
    seeds = jnp.asarray([(seed * 1315423911 + d) & 0x7FFFFFFF
                         for d in range(ndev)], jnp.int32)
    be, fe, nb = run(seeds, jnp.float32(param), jnp.int32(nsteps))
    return int(be), int(fe), int(nb)
