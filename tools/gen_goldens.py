#!/usr/bin/env python3
"""Generate pinned golden fixtures in tests/goldens/ from the C reference.

Compiles the harnesses in tools/golden_harness/ against the read-only
reference checkout (REFERENCE_DIR, default /root/reference), runs them with
deterministic xorshift32 inputs, regenerates the identical inputs in NumPy,
validates tests/golden_model.py bit-for-bit against the reference outputs,
and pins everything as .npz fixtures.

Run once per fixture change:  python tools/gen_goldens.py
The test suite itself never needs the reference checkout or a C compiler.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
REF = Path(os.environ.get("REFERENCE_DIR", "/root/reference"))
SCRATCH = REPO / ".scratch" / "harness"
GOLDENS = REPO / "tests" / "goldens"

sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import golden_model as gm  # noqa: E402
from convolutional_codes.models.codebook import get_code  # noqa: E402

NBLOCKS = 30
NBLOCKS_FANO_RANDOM = 3  # timeout path is slow in the python golden model
SEED = 0xC0DE5EED


# --------------------------------------------------------------------------
# xorshift32 mirror of the harness RNG
# --------------------------------------------------------------------------
class XS32:
    def __init__(self, seed):
        self.s = seed & 0xFFFFFFFF

    def next(self):
        x = self.s
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        self.s = x
        return x


def gen_inputs(code, nblocks, seed, kind, mode):
    """Replicates the draw order of the C harnesses exactly."""
    rng = XS32(seed)
    L, T, M, m = (code.block_length, code.num_block_symbols,
                  code.points_per_symbol, code.symlen_out)
    bits, dists, syms = [], [], []
    for _ in range(nblocks):
        if mode == 1:
            blk = [rng.next() & 1 for _ in range(L)]
            bits.append(blk)
            tx = gm.encode_block(code, blk)
        if kind == "awgn":
            d = np.zeros((T, M), dtype=np.float32)
            for t in range(T):
                for e in range(M):
                    r = rng.next()
                    if mode == 1:
                        d[t, e] = np.float32(0.5 * bin(e ^ int(tx[t])).count("1")
                                             + (r & 0xFF) / 1024.0)
                    else:
                        d[t, e] = np.float32((r & 0xFFFF) / 4096.0)
            dists.append(d)
        elif kind == "bsc":
            if mode == 1:
                rx = []
                for t in range(T):
                    s = int(tx[t])
                    for k in range(m):
                        if rng.next() % 64 == 0:
                            s ^= 1 << k
                    rx.append(s)
                syms.append(rx)
            else:
                mask = M - 1
                syms.append([rng.next() & mask for _ in range(T)])
        elif kind == "enc":
            blk = [rng.next() & 1 for _ in range(L)]
            bits.append(blk)
    return (np.array(bits, dtype=np.int64) if bits else None,
            np.array(dists, dtype=np.float32) if dists else None,
            np.array(syms, dtype=np.int64) if syms else None)


# --------------------------------------------------------------------------
# Harness compilation / execution
# --------------------------------------------------------------------------
def compile_harness(name, harness_c, decoder_c, side):
    SCRATCH.mkdir(parents=True, exist_ok=True)
    out = SCRATCH / name
    incs = ["-I", str(REF / "common" / "include")]
    if side:
        incs += ["-I", str(REF / side / "include")]
    srcs = [str(REPO / "tools" / "golden_harness" / harness_c),
            str(REF / "common" / "codebook.c"),
            str(REF / "common" / "encoder.c")]
    if decoder_c:
        srcs.append(str(REF / side / decoder_c))
    cmd = ["gcc", "-O2", "-o", str(out)] + incs + srcs + ["-lm"]
    subprocess.run(cmd, check=True)
    return out


def run_harness(binary, code_idx, nblocks, seed, mode):
    r = subprocess.run([str(binary), str(code_idx), str(nblocks), str(seed), str(mode)],
                       capture_output=True, text=True, check=True, timeout=600)
    out_bits, metrics = [], []
    for line in r.stdout.splitlines():
        if line.startswith("O"):
            body = line[1:]
            if "|" in body:
                bitpart, metric = body.split("|")
                metrics.append(int(metric))
            else:
                bitpart = body
            out_bits.append([int(x) for x in bitpart.split()])
        elif line.startswith("S"):
            metrics.append([int(x) for x in line[1:].split()])  # enc: symbols
    return np.array(out_bits, dtype=np.int64) if out_bits else None, metrics


def main():
    GOLDENS.mkdir(parents=True, exist_ok=True)
    assert REF.exists(), f"reference not found at {REF}"

    # --- encoder, codes 0-5 -------------------------------------------------
    enc_bin = compile_harness("h_enc", "harness_enc.c", None, None)
    for idx in range(6):
        code = get_code(idx)
        _, out = run_harness(enc_bin, idx, NBLOCKS, SEED + idx, 0)
        ref_syms = np.array(out, dtype=np.int64)
        bits, _, _ = gen_inputs(code, NBLOCKS, SEED + idx, "enc", 0)
        model_syms = np.stack([gm.encode_block(code, b) for b in bits])
        assert np.array_equal(model_syms, ref_syms), f"encoder mismatch code {idx}"
        np.savez(GOLDENS / f"enc_{idx}.npz", bits=bits, symbols=ref_syms)
        print(f"enc code {idx}: OK ({ref_syms.shape})")

    # --- soft decoders (AWGN side) ------------------------------------------
    soft = {
        "viterbi": ("viterbi-decoder.c", [0, 1, 2, 3, 5], gm.viterbi_soft),
        "stack": ("stack-decoder.c", [0, 1, 2, 3, 4, 5], gm.stack_soft),
        "fano": ("fano-decoder.c", [0, 1, 2, 3, 4, 5], gm.fano_soft),
    }
    for dname, (src, codes, model_fn) in soft.items():
        b = compile_harness(f"h_awgn_{dname}", "harness_awgn.c", src, "AWGN-channel")
        for idx in codes:
            code = get_code(idx)
            for mode in (0, 1):
                n = NBLOCKS if not (dname == "fano" and mode == 0) else NBLOCKS_FANO_RANDOM
                ref_bits, _ = run_harness(b, idx, n, SEED + 7 * idx + mode, mode)
                bits, dists, _ = gen_inputs(code, n, SEED + 7 * idx + mode, "awgn", mode)
                model_bits = np.stack([model_fn(code, d) for d in dists])
                assert np.array_equal(model_bits, ref_bits), \
                    f"{dname} soft mismatch code {idx} mode {mode}"
                np.savez(GOLDENS / f"{dname}_soft_{idx}_m{mode}.npz",
                         dists=dists, decoded=ref_bits,
                         **({"tx_bits": bits} if bits is not None else {}))
                print(f"{dname} soft code {idx} mode {mode}: OK")

    # --- hard decoders (BSC side) -------------------------------------------
    hard = {
        "viterbi": ("viterbi-decoder.c", [0, 1, 2, 3, 5],
                    lambda c, s: gm.viterbi_hard(c, s)),
        "stack": ("stack-decoder.c", [0, 1, 2, 3, 4, 5],
                  lambda c, s: (gm.stack_hard(c, s), None)),
        "fano": ("fano-decoder.c", [0, 1, 2, 3, 4, 5],
                 lambda c, s: (gm.fano_hard(c, s), None)),
    }
    for dname, (src, codes, model_fn) in hard.items():
        b = compile_harness(f"h_bsc_{dname}", "harness_bsc.c", src,
                            "binary-symmetric-channel")
        for idx in codes:
            code = get_code(idx)
            for mode in (0, 1):
                n = NBLOCKS if not (dname == "fano" and mode == 0) else NBLOCKS_FANO_RANDOM
                ref_bits, metrics = run_harness(b, idx, n, SEED + 11 * idx + mode, mode)
                bits, _, syms = gen_inputs(code, n, SEED + 11 * idx + mode, "bsc", mode)
                model_out = [model_fn(code, s) for s in syms]
                model_bits = np.stack([o[0] for o in model_out])
                assert np.array_equal(model_bits, ref_bits), \
                    f"{dname} hard mismatch code {idx} mode {mode}"
                extra = {}
                if dname == "viterbi":
                    model_metrics = np.array([o[1] for o in model_out], dtype=np.int64)
                    ref_metrics = np.array(metrics, dtype=np.int64)
                    assert np.array_equal(model_metrics, ref_metrics), \
                        f"viterbi hard metric mismatch code {idx} mode {mode}"
                    extra["metrics"] = ref_metrics
                np.savez(GOLDENS / f"{dname}_hard_{idx}_m{mode}.npz",
                         received=syms, decoded=ref_bits,
                         **({"tx_bits": bits} if bits is not None else {}), **extra)
                print(f"{dname} hard code {idx} mode {mode}: OK")

    print("all goldens pinned + golden model validated against the C reference")


if __name__ == "__main__":
    main()
