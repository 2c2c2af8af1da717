#!/usr/bin/env python3
"""Measure honest same-config C-reference baselines for the bench rows.

Compiles tools/golden_harness/harness_ber_awgn_ext.c against the read-only
reference (-O3, the reference's own optimization level, one core) and times
the full C chain (encoder → mapper → gengauss AWGN → soft demapper →
stack/fano decoder) at the SNRs bench.py measures, for the SAME codes —
including the framework-extension codes, which must not be normalized by
the K=3 core's rate.

Writes results/reference_fresh_awgn_ext.json.
"""

import json
import pathlib
import subprocess
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
REF = pathlib.Path("/root/reference")
SCRATCH = REPO / ".scratch"

#: (metric key, decoder source, harness code idx, Eb/N0 dB, calibration blocks)
CONFIGS = [
    ("stack_k9_8db", "stack-decoder.c", 6, 8.0, 2000),
    ("stack_k3_8db", "stack-decoder.c", 0, 8.0, 5000),
    ("fano_k3_8db", "fano-decoder.c", 0, 8.0, 5000),
    ("fano_k15_16qam_14db", "fano-decoder.c", 8, 14.0, 1000),
    ("fano_k15_16qam_8db", "fano-decoder.c", 8, 8.0, 1000),
    ("fano_wspr_6db", "fano-decoder.c", 4, 6.0, 2000),
]

TARGET_SECONDS = 10.0


def compile_harness(decoder_c: str) -> pathlib.Path:
    SCRATCH.mkdir(parents=True, exist_ok=True)
    out = SCRATCH / f"h_ber_ext_{decoder_c.split('-')[0]}"
    srcs = [
        str(REPO / "tools" / "golden_harness" / "harness_ber_awgn_ext.c"),
        str(REF / "common" / "codebook.c"),
        str(REF / "common" / "encoder.c"),
        str(REF / "common" / "mapper.c"),
        str(REF / "common" / "demapper.c"),
        str(REF / "common" / "gaussian.c"),
        str(REF / "AWGN-channel" / decoder_c),
    ]
    cmd = ["gcc", "-O3", "-o", str(out),
           "-I", str(REF / "common" / "include"),
           "-I", str(REF / "AWGN-channel" / "include")] + srcs + ["-lm"]
    subprocess.run(cmd, check=True)
    return out


def run_timed(binary, code_idx, nblocks, seed, ebn0_db):
    t0 = time.time()
    r = subprocess.run([str(binary), str(code_idx), str(nblocks), str(seed),
                        str(int(round(ebn0_db * 100)))],
                       capture_output=True, text=True, check=True,
                       timeout=1800)
    dt = time.time() - t0
    bits, errs, ferrs = (int(x) for x in r.stdout.split())
    return bits, errs, ferrs, dt


def main():
    rows = {}
    bins = {}
    for key, dec_c, idx, snr, cal_blocks in CONFIGS:
        if dec_c not in bins:
            bins[dec_c] = compile_harness(dec_c)
        b = bins[dec_c]
        # calibrate, then time a >= TARGET_SECONDS run
        bits, _, _, dt = run_timed(b, idx, cal_blocks, 1, snr)
        rate = bits / max(dt, 1e-3)
        nblocks = max(cal_blocks,
                      int(cal_blocks * TARGET_SECONDS / max(dt, 1e-3)))
        bits, errs, ferrs, dt = run_timed(b, idx, nblocks, 2, snr)
        rows[key] = {
            "decoder": dec_c.split("-")[0], "code_idx": idx,
            "ebn0_db": snr, "bits": bits, "bit_errors": errs,
            "frame_errors": ferrs, "ber": errs / bits,
            "wall_s": round(dt, 3), "bits_per_s": round(bits / dt, 1),
            "build": "gcc -O3, one core, reference chain via "
                     "harness_ber_awgn_ext.c",
        }
        print(f"{key}: {rows[key]['bits_per_s']:.3e} bits/s "
              f"BER={rows[key]['ber']:.3e} ({bits} bits, {dt:.1f}s)",
              flush=True)
    out = REPO / "results" / "reference_fresh_awgn_ext.json"
    out.write_text(json.dumps(rows, indent=1))
    print("wrote", out)


if __name__ == "__main__":
    main()
