"""Command-line simulation drivers.

One CLI replaces the reference's three binaries + compile-time component
selection (``CMakeLists.txt:21-45``, ``Readme.md:13-19``):

    python -m convolutional_codes.sim.cli awgn    --code 0 --decoder viterbi
    python -m convolutional_codes.sim.cli bsc     --code 0 --decoder viterbi
    python -m convolutional_codes.sim.cli uncoded --code 0

Decoder, demapper, code, grids, sample sizes, batch, mesh shape and output
paths are all runtime flags.  ``--bits-scale`` shrinks the reference-sized
tiers (8e8-bit base) for quick runs.
"""

from __future__ import annotations

import argparse
import sys

from convolutional_codes.models.codebook import get_code
from convolutional_codes.parallel.mesh import make_mesh
from convolutional_codes.sim.sweep import SweepSpec, run_sweep
from convolutional_codes.utils import records as rec
from convolutional_codes.utils.compile_cache import enable_compile_cache


def _code_key(s: str):
    try:
        return int(s)
    except ValueError:
        return s


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="convolutional_codes.sim")
    sub = p.add_subparsers(dest="channel", required=True)
    for name in ("awgn", "bsc", "uncoded"):
        sp = sub.add_parser(name)
        sp.add_argument("--code", type=_code_key, default=0,
                        help="code registry index or name (default 0)")
        if name != "uncoded":
            sp.add_argument("--decoder", choices=("viterbi", "stack", "fano"),
                            default="viterbi")
            sp.add_argument("--demapper", choices=("soft", "hard"), default="soft")
            sp.add_argument("--timeout-per-bit", type=int, default=10000,
                            help="Fano decode budget (reference TIMEOUT)")
        sp.add_argument("--points", type=float, nargs="*", default=None,
                        help="sweep points (Eb/N0 dB or crossover probs)")
        sp.add_argument("--frames", type=int, default=4096,
                        help="frames per jitted step")
        sp.add_argument("--bits-per-point", type=float, default=None)
        sp.add_argument("--bits-scale", type=float, default=1.0,
                        help="scale the reference 8e8-bit tier base")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--mesh", type=str, default=None,
                        help="mesh shape, e.g. 'frames=8' or 'sweep=2,frames=4'")
        sp.add_argument("--jsonl", type=str, default=None)
        sp.add_argument("--octave", type=str, default=None)
        sp.add_argument("--checkpoint", type=str, default=None,
                        help="JSON checkpoint for resumable sweeps")
        sp.add_argument("--trace", type=str, default=None, metavar="DIR",
                        help="capture per-point XProf traces under DIR")
    return p


def parse_mesh(arg):
    if not arg:
        return None
    shape = {}
    for part in arg.split(","):
        k, v = part.split("=")
        shape[k.strip()] = int(v)
    return make_mesh(shape)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    enable_compile_cache()
    spec = SweepSpec(
        code=args.code,
        channel=args.channel,
        decoder=getattr(args, "decoder", "viterbi"),
        demapper=getattr(args, "demapper", "soft"),
        points=args.points,
        frames_per_step=args.frames,
        bits_per_point=args.bits_per_point,
        base_bits=8e8 * args.bits_scale,
        seed=args.seed,
        timeout_per_bit=getattr(args, "timeout_per_bit", 10000),
        trace_dir=args.trace,
    )
    mesh = parse_mesh(args.mesh)
    code = get_code(args.code)
    print(f"code {code.name}: K={code.constraint_length} "
          f"rate 1/{code.symlen_out} block={code.block_length} "
          f"polys={[oct(p) for p in code.polynomials]} parity={code.parity}")
    results = run_sweep(spec, mesh=mesh, checkpoint_path=args.checkpoint)
    if args.jsonl:
        rec.write_jsonl(results, args.jsonl)
    if args.octave:
        if args.channel == "uncoded":
            # uncoded rows run no decoder and ignore the code tables — name
            # the export from the record fields (uncoded-{m}bit / argmin),
            # not the coded spec, so curve tooling keyed on names cannot
            # mistake it for a coded curve
            var = f"uncoded_{code.symlen_out}bit_argmin"
        else:
            var = f"{args.channel}_{spec.decoder}_{code.name}".replace("-", "_")
        rec.write_octave([(var, results)], args.octave)
    return 0


if __name__ == "__main__":
    sys.exit(main())
