"""Monte-Carlo BER/FER sweep runner with tiered sample counts.

Mirrors the reference drivers' sweep behavior (SNR grid and adaptive sample
tiers, ``AWGN-channel/main.c:150-211``; crossover grid and tiers,
``binary-symmetric-channel/main.c:103-156``) as a structured, resumable,
mesh-shardable runner producing per-point records
{code, channel, decoder, demapper, point, bits, errors, BER, FER, wall time,
throughput} — the observability the reference only printf'd (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from convolutional_codes.models.codebook import Code, get_code
from convolutional_codes.ops.channels import awgn_sigma
from convolutional_codes.ops.fano import FANO_TIMEOUT
from convolutional_codes.parallel.mesh import frames_axis_size
from convolutional_codes.parallel.montecarlo import (
    fused_grid_accumulate, fused_mc_accumulate, grid_accumulate_with_keys,
    sharded_accumulate)
from convolutional_codes.sim.chain import make_point_step, make_uncoded_step
from convolutional_codes.sim.paths import (
    SEQUENTIAL_KERNEL, VITERBI_KERNEL, choose_path, current_platform)

#: Default Eb/N0 grid in dB (AWGN-channel/main.c:150-152).
AWGN_SNR_GRID = (0.0, 2.0, 4.0, 6.0, 8.0, 10.0, 12.0, 14.0)

#: Default crossover grid (binary-symmetric-channel/main.c:103-109).
BSC_CROSSOVER_GRID = tuple(r / 1e6 for r in (
    1, 5, 25, 125, 625, 3125, 6250, 12500, 15625, 25000, 50000,
    78125, 100000, 200000, 300000, 390625, 400000))


def awgn_tier_bits(snr_db: float, base_bits: float = 8e8) -> int:
    """Adaptive sample tiers: /10 at <=10, <=6, <=4 dB cumulatively
    (AWGN-channel/main.c:202-211)."""
    bits = base_bits
    if snr_db <= 4.0:
        bits /= 10
    if snr_db <= 6.0:
        bits /= 10
    if snr_db <= 10.0:
        bits /= 10
    return int(bits)


def bsc_tier_bits(crossover: float, base_bits: float = 8e8) -> int:
    """Tiers: /10 above p=0.0125, 0.05, 0.2 cumulatively
    (binary-symmetric-channel/main.c:147-156)."""
    bits = base_bits
    if crossover > 0.0125:
        bits /= 10
    if crossover > 0.05:
        bits /= 10
    if crossover > 0.2:
        bits /= 10
    return int(bits)


@dataclasses.dataclass
class SweepSpec:
    """Full configuration of one sweep (the config surface the reference
    scattered over CMake component selection + argv, SURVEY.md §5)."""

    code: object = 0                      # registry key or Code
    channel: str = "awgn"                 # awgn | bsc | uncoded
    decoder: str = "viterbi"              # viterbi | stack | fano
    demapper: str = "soft"                # soft | hard
    points: Optional[Sequence[float]] = None   # Eb/N0 dB or crossover probs
    frames_per_step: int = 4096
    bits_per_point: Optional[float] = None     # override tiering
    base_bits: float = 8e8                # tier base (reference default)
    seed: int = 0
    timeout_per_bit: int = FANO_TIMEOUT
    trace_dir: Optional[str] = None       # XProf trace output (None = off)

    def resolve_code(self) -> Code:
        return self.code if isinstance(self.code, Code) else get_code(self.code)

    def resolve_points(self) -> Sequence[float]:
        if self.points is not None:
            return tuple(self.points)
        return AWGN_SNR_GRID if self.channel in ("awgn", "uncoded") else BSC_CROSSOVER_GRID


@dataclasses.dataclass
class PointRecord:
    code: str
    channel: str
    decoder: str
    demapper: str
    point: float            # Eb/N0 dB (awgn/uncoded) or crossover prob (bsc)
    param: float            # sigma or crossover actually applied
    bits: int
    bit_errors: int
    frame_errors: int       # uncoded: symbol errors (frame == one symbol)
    frames: int             # uncoded: symbols
    ber: float
    fer: float              # uncoded: symbol error rate
    #: timing of the run that produced the record (None in committed
    #: records, which keep the counters only)
    wall_s: Optional[float] = None
    bits_per_s: Optional[float] = None  # warm steady-state rate when measurable
    #: measurement hygiene: the first accumulate chunk of a point pays
    #: compilation; bits/wall of the remaining chunks are the steady-state
    #: numbers (0/0.0 when the point ran as a single chunk, in which case
    #: bits_per_s falls back to the total-wall rate)
    warm_bits: int = 0
    warm_wall_s: float = 0.0

    def to_dict(self):
        return dataclasses.asdict(self)


def _spec_fingerprint(spec: SweepSpec, code: Code) -> str:
    """Hash of everything that determines a sweep's counters.  Stored in the
    checkpoint as ``__spec__``; ``run_sweep`` refuses to resume from a
    checkpoint whose fingerprint differs (per-point resume silently *skips*
    matching points, so a stale checkpoint from another spec would quietly
    keep its old counters)."""
    payload = {
        "code": code.name,
        "polys": list(code.polynomials),
        "K": code.constraint_length,
        "L": code.block_length,
        "parity": code.parity,
        "channel": spec.channel,
        "decoder": spec.decoder,
        "demapper": spec.demapper,
        "base_bits": spec.base_bits,
        "bits_per_point": spec.bits_per_point,
        "seed": spec.seed,
        "timeout_per_bit": spec.timeout_per_bit,
        "frames_per_step": spec.frames_per_step,
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()[:16]


def run_sweep(spec: SweepSpec, mesh=None, checkpoint_path: Optional[str] = None,
              verbose: bool = True) -> List[PointRecord]:
    """Run the sweep, optionally sharded over ``mesh`` ('frames' axis) and
    resumable via a JSON checkpoint of per-point counters (the reference has
    no resume story — every block is independent, so (seed, counters) is the
    complete state, SURVEY.md §5)."""
    from convolutional_codes.utils.profiling import annotate, trace

    code = spec.resolve_code()
    points = spec.resolve_points()
    ndev = frames_axis_size(mesh)

    if spec.channel == "uncoded":
        step = make_uncoded_step(code.symlen_out, spec.frames_per_step)
        frame_bits = code.symlen_out
        frames = spec.frames_per_step
        tier = lambda p: awgn_tier_bits(p, spec.base_bits)
        to_param = lambda p: float(awgn_sigma(p, info_bits_per_symbol=code.symlen_out))
    else:
        step = make_point_step(code, spec.channel, spec.decoder, spec.demapper,
                               spec.frames_per_step, spec.timeout_per_bit)
        frame_bits = code.block_length
        frames = spec.frames_per_step
        if spec.channel == "awgn":
            tier = lambda p: awgn_tier_bits(p, spec.base_bits)
            to_param = lambda p: float(awgn_sigma(p))
        else:
            tier = lambda p: bsc_tier_bits(p, spec.base_bits)
            to_param = lambda p: float(p)

    done_points = {}
    spec_fp = _spec_fingerprint(spec, code)
    if checkpoint_path:
        try:
            with open(checkpoint_path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            raw = None
        if raw is not None:
            if raw.get("__spec__") != spec_fp:
                raise ValueError(
                    f"checkpoint {checkpoint_path} was written by a different "
                    f"sweep spec (fingerprint {raw.get('__spec__')!r} != "
                    f"{spec_fp!r}); refusing to resume — delete it or point "
                    "the sweep elsewhere")
            done_points = {float(k): v for k, v in raw.items()
                           if k != "__spec__"}

    path = choose_path(current_platform(), code, spec.channel, spec.decoder,
                       spec.demapper)
    use_fused = path == VITERBI_KERNEL
    seq_mc = path == SEQUENTIAL_KERNEL
    fused_batch = max(1024, -(-frames // 1024) * 1024) if use_fused else frames

    records_by_idx = {}
    key = jax.random.PRNGKey(spec.seed)
    eff_frames = fused_batch if use_fused else frames
    bits_per_call = eff_frames * frame_bits * ndev
    # chunk scans so int32 counters cannot overflow and dispatches stay
    # reasonably sized
    chunk = max(1, (1 << 30) // max(1, eff_frames * frame_bits))
    uncoded = spec.channel == "uncoded"

    def finish_point(i, point, param, be, fe, nb, wall,
                     warm_bits=0, warm_wall=0.0):
        rate = (warm_bits / warm_wall if warm_wall > 0
                else (nb / wall if wall > 0 else float("inf")))
        rec = PointRecord(
            code=f"uncoded-{code.symlen_out}bit" if uncoded else code.name,
            channel=spec.channel,
            decoder="argmin" if uncoded else spec.decoder,
            demapper=spec.demapper, point=float(point), param=param,
            bits=nb, bit_errors=be, frame_errors=fe,
            frames=nb // frame_bits, ber=be / nb, fer=fe / (nb // frame_bits),
            wall_s=wall, bits_per_s=rate,
            warm_bits=warm_bits, warm_wall_s=warm_wall)
        records_by_idx[i] = rec
        if verbose:
            print(f"[{spec.channel}/{spec.decoder}/{spec.demapper} {code.name}] "
                  f"point={point:g} bits={nb:.3g} BER={rec.ber:.6e} "
                  f"FER={rec.fer:.3e} {rec.bits_per_s:.3e} bits/s", flush=True)
        if checkpoint_path:
            done_points[point] = rec.to_dict()
            payload = {str(k): v for k, v in done_points.items()}
            payload["__spec__"] = spec_fp
            with open(checkpoint_path, "w") as f:
                json.dump(payload, f)

    # plan: (index, point, param, nsteps) for every point not checkpointed
    pending = []
    for i, point in enumerate(points):
        if point in done_points:
            records_by_idx[i] = PointRecord(**done_points[point])
            continue
        target_bits = int(spec.bits_per_point or tier(point))
        nsteps = max(1, -(-target_bits // bits_per_call))
        pending.append((i, point, to_param(point), nsteps))

    def seq_plan(point):
        """(global lanes, frames per lane) for a sequential MC point —
        shared by the serial and mesh-sharded legs so both cover the same
        frame-id space (bit-identical counters)."""
        target_bits = int(spec.bits_per_point or tier(point))
        lanes = 8192 if target_bits >= 8192 * frame_bits else 1024
        fpl = max(1, -(-target_bits // (lanes * frame_bits)))
        return lanes, fpl

    # ---- sweep×frames grid batches (SURVEY §2e sweep parallelism) --------
    # Points with equal step counts run concurrently across the `sweep`
    # mesh axis, each group psum-reducing over `frames`; per-point keys are
    # derived exactly as the serial path derives them, so counters are
    # identical to a serial run.
    grid_ok = (mesh is not None and "sweep" in mesh.axis_names
               and "frames" in mesh.axis_names and not seq_mc)
    if grid_ok:
        Ds = mesh.shape["sweep"]
        by_steps = {}
        for item in pending:
            by_steps.setdefault(item[3], []).append(item)
        serial_rest = []
        for nsteps, group in by_steps.items():
            while len(group) >= Ds:
                batch_items, group = group[:Ds], group[Ds:]
                t0 = time.time()
                be = np.zeros(Ds, np.int64); fe = np.zeros(Ds, np.int64)
                nb = np.zeros(Ds, np.int64)
                wb = np.zeros(Ds, np.int64); ww = 0.0
                left, ci = nsteps, 0
                prms = [it[2] for it in batch_items]
                with annotate("sweep_grid_batch"):
                    tc = time.time()
                    while left > 0:
                        n = min(chunk, left)
                        # single-chunk points would record no warm rate
                        # (chunk 0 pays compile): shrink the cold chunk so
                        # every point gets a warm split.  MUST stay
                        # identical to the serial leg below — the chunk
                        # partition feeds the per-chunk seed derivation
                        # (counter identity, test_sweep.py).
                        if ci == 0 and n == nsteps and n > 1:
                            n = max(1, n // 8)
                        if use_fused:
                            # replicate fused_mc_accumulate's seed derivation
                            # exactly (counter identity with the serial path)
                            seeds = np.array(
                                [[(((spec.seed * 1000003 + it[0] * 7919 + ci)
                                    & 0x7FFFFFFF) * 1315423911 + d)
                                  & 0x7FFFFFFF for d in range(ndev)]
                                 for it in batch_items], np.int64).astype(np.int32)
                            cbe, cfe, cnb = fused_grid_accumulate(
                                code, n, seeds, prms, fused_batch, mesh,
                                channel=spec.channel, demapper=spec.demapper)
                        else:
                            keys = jnp.stack([
                                jax.random.split(jax.random.fold_in(
                                    jax.random.fold_in(key, it[0]), ci), ndev)
                                for it in batch_items])
                            cbe, cfe, cnb = grid_accumulate_with_keys(
                                step, n, keys, prms, mesh)
                        be += np.asarray(cbe, np.int64)
                        fe += np.asarray(cfe, np.int64)
                        nb += np.asarray(cnb, np.int64)
                        if ci > 0:                  # chunk 0 pays compile
                            wb += np.asarray(cnb, np.int64)
                            ww += time.time() - tc
                        left -= n; ci += 1
                        tc = time.time()
                wall = (time.time() - t0) / Ds    # concurrent: amortized
                for r, (i, point, param, _) in enumerate(batch_items):
                    finish_point(i, point, param, int(be[r]), int(fe[r]),
                                 int(nb[r]), wall, int(wb[r]), ww / Ds)
            serial_rest.extend(group)
        pending = sorted(serial_rest)

    # ---- sequential MC kernels on the mesh (SURVEY §2e data + sweep
    # parallelism for the dominant-cost decoders): points with identical
    # (lanes, fpl) plans run as groups of R across the whole mesh, each
    # point's global lane set split into per-device blocks with lane0
    # offsets — counters are bit-identical to the serial seq_mc leg below
    # (parallel/seq_grid.py, tests/test_seq_grid.py).
    seq_ndev = (int(np.prod(list(mesh.shape.values())))
                if mesh is not None else 1)
    # spec.trace_dir implies the serial per-point leg: the batched leg runs
    # several points in one dispatch, so a per-point XProf capture would be
    # meaningless
    if seq_mc and seq_ndev > 1 and not spec.trace_dir:
        from convolutional_codes.parallel.seq_grid import seq_mc_grid
        by_plan = {}
        for item in pending:
            by_plan.setdefault(seq_plan(item[1]), []).append(item)
        pending = []
        for (lanes, fpl), group in sorted(by_plan.items()):
            while group:
                R = 0
                for d in range(min(len(group), seq_ndev), 0, -1):
                    if seq_ndev % d == 0 and lanes % (seq_ndev // d) == 0:
                        R = d
                        break
                if R == 0:
                    # no (points, devices, lanes) grouping divides evenly
                    # (e.g. a 6-device mesh with 1024 lanes): run these
                    # points on the single-device serial leg below
                    pending.extend(group)
                    break
                batch_items, group = group[:R], group[R:]
                seeds = [(spec.seed * 1000003 + it[0] * 7919) & 0x7FFFFFFF
                         for it in batch_items]
                prms = [it[2] for it in batch_items]
                kw = dict(channel=spec.channel, demapper=spec.demapper)
                if spec.decoder == "fano":
                    kw["timeout_per_bit"] = spec.timeout_per_bit
                t0 = time.time()
                with annotate("seq_grid_batch"):
                    # cold slice pays compile; remainder is the warm rate
                    be, fe, nb = seq_mc_grid(spec.decoder, code, lanes, 1,
                                             seeds, prms, mesh, **kw)
                    wb = np.zeros(R, np.int64)
                    ww = 0.0
                    if fpl > 1:
                        tw = time.time()
                        b2, f2, n2 = seq_mc_grid(
                            spec.decoder, code, lanes, fpl - 1,
                            [s ^ 0x2A5A5A5A for s in seeds], prms, mesh,
                            **kw)
                        ww = time.time() - tw
                        be = be + b2; fe = fe + f2; nb = nb + n2; wb = n2
                wall = (time.time() - t0) / R    # concurrent: amortized
                for r, (i, point, param, _) in enumerate(batch_items):
                    finish_point(i, point, param, int(be[r]), int(fe[r]),
                                 int(nb[r]), wall, int(wb[r]), ww / R)

    for i, point, param, nsteps in pending:
        pkey = jax.random.fold_in(key, i)
        if seq_mc:
            from convolutional_codes.ops import sequential_mc
            if spec.decoder == "fano":
                mc = sequential_mc.mc_fano
                kw = dict(channel=spec.channel, demapper=spec.demapper,
                          timeout_per_bit=spec.timeout_per_bit)
            else:
                mc = sequential_mc.mc_stack
                kw = dict(channel=spec.channel, demapper=spec.demapper)
            lanes, fpl = seq_plan(point)
            seed_i = (spec.seed * 1000003 + i * 7919) & 0x7FFFFFFF
            t0 = time.time()
            pt_trace = (f"{spec.trace_dir}/point_{point:g}"
                        if spec.trace_dir else None)
            with trace(pt_trace), annotate(f"sweep_point_{point:g}"):
                # cold slice pays compile; remainder is the warm rate
                be, fe, nb = mc(code, lanes, 1, seed_i, param, **kw)
                wb = ww = 0
                if fpl > 1:
                    tw = time.time()
                    b2, f2, n2 = mc(code, lanes, fpl - 1,
                                    seed_i ^ 0x2A5A5A5A, param, **kw)
                    ww = time.time() - tw
                    be += b2; fe += f2; nb += n2; wb = n2
            finish_point(i, point, param, be, fe, nb, time.time() - t0,
                         wb, ww)
            continue
        t0 = time.time()
        be = fe = nb = 0
        wb = 0; ww = 0.0
        left = nsteps
        ci = 0
        # per-point XProf capture (utils/profiling; no-op when trace_dir
        # is unset) — the profiling story the reference solved with printf
        pt_trace = (f"{spec.trace_dir}/point_{point:g}"
                    if spec.trace_dir else None)
        with trace(pt_trace), annotate(f"sweep_point_{point:g}"):
            tc = time.time()
            while left > 0:
                n = min(chunk, left)
                # small cold chunk for single-chunk points (see the grid
                # leg above — the partitions must match exactly)
                if ci == 0 and n == nsteps and n > 1:
                    n = max(1, n // 8)
                if use_fused:
                    seed_i = (spec.seed * 1000003 + i * 7919 + ci) & 0x7FFFFFFF
                    cbe, cfe, cnb = fused_mc_accumulate(
                        code, n, seed_i, param, fused_batch, mesh,
                        channel=spec.channel, demapper=spec.demapper)
                else:
                    cbe, cfe, cnb = sharded_accumulate(
                        step, n, jax.random.fold_in(pkey, ci), param, mesh)
                be += cbe; fe += cfe; nb += cnb
                if ci > 0:                          # chunk 0 pays compile
                    wb += cnb
                    ww += time.time() - tc
                left -= n; ci += 1
                tc = time.time()
        wall = time.time() - t0
        # uncoded rows: no decoder runs (argmin symbol decision,
        # uncoded/main.c:104-111) and the code tables are unused
        finish_point(i, point, param, be, fe, nb, wall, wb, ww)

    return [records_by_idx[i] for i in sorted(records_by_idx)]
