"""ctypes bindings for the native host runtime (native/convcodes_native.c).

Builds the shared library on first use (gcc -O3 -shared) into
``native/build/``, which git does not track, and exposes batch encoder/Viterbi/stack/Fano entry
points as NumPy functions.  Used as a fast fuzz oracle in tests (a ~1000×
faster stand-in for the scalar spec in tests/golden_model.py, validated
against it) and as a host-side fallback decoder.  Gated: ``available()``
is False when no C compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

from convolutional_codes.models.codebook import Code, PARITY_COMPAT

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "convcodes_native.c")
_BUILD_DIR = os.path.join(_ROOT, "native", "build")
_LIB = os.path.join(_BUILD_DIR, "libconvcodes_native.so")

_MAX_POLYS = 8


class _Params(ctypes.Structure):
    _fields_ = [
        ("symlen_out", ctypes.c_int32),
        ("constraint_length", ctypes.c_int32),
        ("block_length", ctypes.c_int32),
        ("compat_parity", ctypes.c_int32),
        ("polynomials", ctypes.c_uint32 * _MAX_POLYS),
    ]


def _params(code: Code) -> _Params:
    p = _Params()
    p.symlen_out = code.symlen_out
    p.constraint_length = code.constraint_length
    p.block_length = code.block_length
    p.compat_parity = 1 if code.parity == PARITY_COMPAT else 0
    for i, poly in enumerate(code.polynomials):
        p.polynomials[i] = poly
    return p


def build_library(src: str, lib: str, command) -> None:
    """Build ``lib`` from ``src`` with ``command(output_path)`` unless it is
    up to date.  Processes that start together (test workers) serialize on
    a lock file, and the library appears under its name only when complete.
    Raises OSError or subprocess.CalledProcessError when the build fails."""
    import fcntl

    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
            return
        partial = lib + ".partial"
        subprocess.run(command(partial), check=True, capture_output=True,
                       text=True)
        os.replace(partial, lib)


@lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_SRC):
        return None
    cc = os.environ.get("CC", "gcc")
    # -ffp-contract=off: the soft stack/Fano metrics compute 1.0f + w*dist
    # and the golden contract rounds the product BEFORE the add (see
    # ops/sequential_common.force_rounded).  Toolchains that contract onto
    # FMA by default (aarch64 gcc, clang) would otherwise make this oracle
    # deviate from golden_model.py.
    try:
        build_library(_SRC, _LIB, lambda out: [
            cc, "-O3", "-ffp-contract=off", "-shared", "-fPIC", "-o", out,
            _SRC, "-lm"])
    except (OSError, subprocess.CalledProcessError):
        return None
    lib = ctypes.CDLL(_LIB)
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.cc_encode_blocks.argtypes = [ctypes.POINTER(_Params), i8p, i32p,
                                     ctypes.c_int64]
    lib.cc_viterbi_soft_blocks.argtypes = [ctypes.POINTER(_Params), f32p, i8p,
                                           ctypes.c_int64]
    lib.cc_viterbi_hard_blocks.argtypes = [ctypes.POINTER(_Params), i32p, i8p,
                                           i32p, ctypes.c_int64]
    lib.cc_stack_soft_blocks.argtypes = [ctypes.POINTER(_Params), f32p,
                                         ctypes.c_float, i8p, ctypes.c_int64]
    lib.cc_stack_hard_blocks.argtypes = [ctypes.POINTER(_Params), i32p,
                                         ctypes.c_int32, ctypes.c_int32, i8p,
                                         ctypes.c_int64]
    lib.cc_fano_soft_blocks.argtypes = [ctypes.POINTER(_Params), f32p,
                                        ctypes.c_float, ctypes.c_float,
                                        ctypes.c_int32, i8p, i8p,
                                        ctypes.c_int64]
    lib.cc_fano_hard_blocks.argtypes = [ctypes.POINTER(_Params), i32p,
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_int32,
                                        i8p, i8p, ctypes.c_int64]
    return lib


def available() -> bool:
    return _load() is not None


def encode_blocks(code: Code, bits: np.ndarray) -> np.ndarray:
    """bits [N, L] {0,1} → symbols [N, T] int32 (tail-terminated)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    bits = np.ascontiguousarray(bits, dtype=np.int8)
    n, L = bits.shape
    assert L == code.block_length
    out = np.empty((n, code.num_block_symbols), dtype=np.int32)
    lib.cc_encode_blocks(ctypes.byref(_params(code)), bits, out, n)
    return out


def viterbi_soft_blocks(code: Code, dists: np.ndarray) -> np.ndarray:
    """dists [N, T, 2^m] float32 → decoded bits [N, L] int8."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    n = dists.shape[0]
    assert dists.shape[1:] == (code.num_block_symbols, code.points_per_symbol)
    out = np.empty((n, code.block_length), dtype=np.int8)
    lib.cc_viterbi_soft_blocks(ctypes.byref(_params(code)), dists, out, n)
    return out


def viterbi_hard_blocks(code: Code, rx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """rx [N, T] int32 symbols → (bits [N, L] int8, path metrics [N] int32)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    rx = np.ascontiguousarray(rx, dtype=np.int32)
    n = rx.shape[0]
    assert rx.shape[1] == code.num_block_symbols
    out = np.empty((n, code.block_length), dtype=np.int8)
    metrics = np.empty((n,), dtype=np.int32)
    lib.cc_viterbi_hard_blocks(ctypes.byref(_params(code)), rx, out, metrics, n)
    return out, metrics


def stack_soft_blocks(code: Code, dists: np.ndarray) -> np.ndarray:
    """dists [N, T, 2^m] float32 → decoded bits [N, L] int8 (spec:
    tests/golden_model.py _stack_decode soft path)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    n = dists.shape[0]
    assert dists.shape[1:] == (code.num_block_symbols, code.points_per_symbol)
    out = np.empty((n, code.block_length), dtype=np.int8)
    lib.cc_stack_soft_blocks(ctypes.byref(_params(code)), dists,
                             ctypes.c_float(code.metric_weight), out, n)
    return out


def stack_hard_blocks(code: Code, rx: np.ndarray) -> np.ndarray:
    """rx [N, T] int32 symbols → decoded bits [N, L] int8."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    rx = np.ascontiguousarray(rx, dtype=np.int32)
    n = rx.shape[0]
    assert rx.shape[1] == code.num_block_symbols
    out = np.empty((n, code.block_length), dtype=np.int8)
    lib.cc_stack_hard_blocks(ctypes.byref(_params(code)), rx,
                             code.bit_metrics[0], code.bit_metrics[1], out, n)
    return out


def fano_soft_blocks(code: Code, dists: np.ndarray,
                     timeout_per_bit: int = 10000, delta: float = 17.0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """dists [N, T, 2^m] float32 → (bits [N, L] int8, timed_out [N] int8)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    dists = np.ascontiguousarray(dists, dtype=np.float32)
    n = dists.shape[0]
    assert dists.shape[1:] == (code.num_block_symbols, code.points_per_symbol)
    out = np.empty((n, code.block_length), dtype=np.int8)
    tout = np.empty((n,), dtype=np.int8)
    lib.cc_fano_soft_blocks(ctypes.byref(_params(code)), dists,
                            ctypes.c_float(code.fano_metric_weight),
                            ctypes.c_float(delta), timeout_per_bit,
                            out, tout, n)
    return out, tout


def fano_hard_blocks(code: Code, rx: np.ndarray,
                     timeout_per_bit: int = 10000, delta: int = 17
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """rx [N, T] int32 symbols → (bits [N, L] int8, timed_out [N] int8)."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    rx = np.ascontiguousarray(rx, dtype=np.int32)
    n = rx.shape[0]
    assert rx.shape[1] == code.num_block_symbols
    out = np.empty((n, code.block_length), dtype=np.int8)
    tout = np.empty((n,), dtype=np.int8)
    lib.cc_fano_hard_blocks(ctypes.byref(_params(code)), rx,
                            code.fano_bit_metrics[0],
                            code.fano_bit_metrics[1], delta,
                            timeout_per_bit, out, tout, n)
    return out, tout
