"""Stack and Fano decoding one frame per thread, and the Monte-Carlo
driver around it.

The decoder is native/seq_decode.cu, called through the XLA foreign
function interface.  On the GPU it is the CUDA kernel, built with nvcc for
sm_90a; on the CPU the same source is built with the host compiler and
runs the identical per-frame walks serially, which is how the tests reach
it.  Either library is built from the committed source on first use into
``native/build/`` (``python -m convolutional_codes.ops.sequential_mc``
builds it ahead of time).

A Monte-Carlo point is a frame-id space ``gid = lane * frames_per_lane +
f``: each chunk of frames is generated by ops/mc_datagen in one fused XLA
pass, decoded by the kernel, and compared with its info bits, all inside
one jitted call.  The decoded bits are those of ops/stack.py and
ops/fano.py on the same frames, so the counters equal the XLA machines'
bit for bit.
"""

from __future__ import annotations

import functools
import os
import subprocess
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from convolutional_codes.models.codebook import PARITY_COMPAT, Code
from convolutional_codes.models.constellations import register_dependent_cache
from convolutional_codes.ops.fano import FANO_DELTA, FANO_TIMEOUT
from convolutional_codes.ops.mc_datagen import make_datagen
from convolutional_codes.utils.native import build_library

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "seq_decode.cu")
_BUILD_DIR = os.path.join(_ROOT, "native", "build")

#: longest frame (block + tail) the kernel holds per thread (kMaxT)
MAX_SYMBOLS = 256

#: device memory one Monte-Carlo chunk's generated frames may take
_CHUNK_BYTES = 1 << 29

_SUFFIX = {"gpu": "Cuda", "cpu": "Cpu"}
_FFI_PLATFORM = {"gpu": "CUDA", "cpu": "cpu"}


def eligible(code: Code) -> bool:
    return code.num_block_symbols <= MAX_SYMBOLS


def _build_command(platform: str, out: str):
    inc = jax.ffi.include_dir()
    if platform == "gpu":
        nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-fmad=false", "-shared",
                "-Xcompiler", "-fPIC", "-I", inc, "-o", out, _SRC]
    cxx = os.environ.get("CXX", "g++")
    return [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
            "-shared", "-fPIC", "-I", inc, "-o", out, _SRC]


@functools.lru_cache(maxsize=None)
def _register(platform: str) -> str:
    """Build (if stale) and load the library for ``platform``, register its
    FFI targets, and return the target-name suffix."""
    import ctypes

    if platform not in _SUFFIX:
        raise ValueError(f"no sequential decoder build for platform "
                         f"{platform!r}")
    lib_path = os.path.join(_BUILD_DIR, f"libseq_decode_{platform}.so")
    try:
        build_library(_SRC, lib_path,
                      lambda out: _build_command(platform, out))
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"building {_SRC} failed:\n{e.stderr}") from e
    lib = ctypes.CDLL(lib_path)
    suffix = _SUFFIX[platform]
    for dec in ("Stack", "Fano"):
        for kind in ("Soft", "Hard"):
            name = f"Seq{dec}{kind}{suffix}"
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, name)),
                platform=_FFI_PLATFORM[platform])
    return suffix


def sequential_decode(decoder: str, code: Code, syms: jnp.ndarray,
                      timeout_per_bit: int = FANO_TIMEOUT) -> jnp.ndarray:
    """Decode ``[N, T, 2^m]`` soft distances or ``[N, T]`` received hard
    symbols with the stack or Fano search, one frame per thread.  Returns
    ``[N, block_length]`` int8 bits, identical to ops/stack.py and
    ops/fano.py on the same input."""
    if decoder not in ("stack", "fano"):
        raise ValueError(f"not a sequential decoder: {decoder!r}")
    if not eligible(code):
        raise ValueError(f"{code.name}: frames of {code.num_block_symbols} "
                         f"symbols exceed the kernel's {MAX_SYMBOLS}")
    T = code.num_block_symbols
    soft = syms.ndim == 3
    want = (T, code.points_per_symbol) if soft else (T,)
    if syms.shape[1:] != want:
        raise ValueError(f"symbols {syms.shape} do not match [N, {want}]")
    suffix = _register(jax.devices()[0].platform)
    fano = decoder == "fano"
    bm = code.fano_bit_metrics if fano else code.bit_metrics
    name = f"Seq{decoder.capitalize()}{'Soft' if soft else 'Hard'}{suffix}"
    n = syms.shape[0]
    bits, _ = jax.ffi.ffi_call(
        name,
        (jax.ShapeDtypeStruct((n, code.block_length), jnp.int8),
         jax.ShapeDtypeStruct((1,), jnp.int32)),
    )(syms.astype(jnp.float32 if soft else jnp.int32),
      polys=np.asarray(code.polynomials, np.int64),
      K=np.int32(code.constraint_length), L=np.int32(code.block_length),
      symlen=np.int32(code.symlen_out),
      compat=bool(code.parity == PARITY_COMPAT),
      weight=np.float32(code.fano_metric_weight if fano
                        else code.metric_weight),
      bm0=np.int32(bm[0]), bm1=np.int32(bm[1]),
      fdelta=np.float32(FANO_DELTA), idelta=np.int32(int(FANO_DELTA)),
      timeout_per_bit=np.int64(timeout_per_bit))
    return bits


def frames_per_chunk(code: Code, lanes: int, frames_per_lane: int,
                     channel: str) -> int:
    """Frames per lane in one jitted chunk: as many as fit the generated
    frames (info bits, symbols, decoded bits) in ``_CHUNK_BYTES``."""
    T = code.num_block_symbols
    per_frame = T * 4 * (1 + (code.points_per_symbol if channel == "awgn"
                              else 1)) + code.block_length
    return max(1, min(frames_per_lane, _CHUNK_BYTES // (lanes * per_frame)))


def chunk_counts(decoder: str, code: Code, lanes: int, fc: int,
                 channel: str, demapper: str, timeout_per_bit: int):
    """``(seed, param, lane0, f0, fpl) -> (bit_errors, frame_errors)`` int32
    for frames ``f0 .. f0+fc-1`` of lanes ``lane0 .. lane0+lanes-1`` (frames
    past ``fpl`` are decoded but not counted)."""
    T = code.num_block_symbols
    L = code.block_length
    gen = make_datagen(code, T, L, channel, demapper)

    def run(seed, param, lane0, f0, fpl):
        lane = lane0 + jnp.arange(lanes, dtype=jnp.int32)
        f = f0 + jnp.arange(fc, dtype=jnp.int32)
        gid = (lane[:, None] * fpl + f[None, :]).reshape(-1, 1)
        bits, syms = gen(gid, jnp.arange(T)[None, :], seed, param)
        dec = sequential_decode(decoder, code, syms, timeout_per_bit)
        valid = jnp.broadcast_to(f[None, :] < fpl, (lanes, fc)).reshape(-1)
        err = (dec != bits[:, :L]) & valid[:, None]
        return (err.sum(dtype=jnp.int32),
                err.any(axis=1).sum(dtype=jnp.int32))

    return run


@functools.lru_cache(maxsize=None)
def _jitted(decoder, code, lanes, fc, channel, demapper, timeout_per_bit):
    return jax.jit(chunk_counts(decoder, code, lanes, fc, channel, demapper,
                                timeout_per_bit))


# the datagen embeds the constellation table of code.symlen_out
register_dependent_cache(_jitted.cache_clear)


def mc_sequential(decoder: str, code: Code, lanes: int,
                  frames_per_lane: int, seed, param, channel: str = "awgn",
                  demapper: str = "soft",
                  timeout_per_bit: int = FANO_TIMEOUT,
                  lane0: int = 0) -> Tuple[int, int, int]:
    """Decode the ``lanes * frames_per_lane`` frames of lanes ``lane0 ..``
    of a point's frame-id space.  Returns (bit_errors, frame_errors, info
    bits) as Python ints."""
    if (int(lane0) + lanes) * frames_per_lane >= 2 ** 31:
        raise ValueError("frame ids exceed int32")
    fc = frames_per_chunk(code, lanes, frames_per_lane, channel)
    run = _jitted(decoder, code, lanes, fc, channel, demapper,
                  int(timeout_per_bit) if decoder == "fano" else 0)
    args = (jnp.int32(int(seed) & 0x7FFFFFFF), jnp.float32(param),
            jnp.int32(lane0))
    outs = [run(*args, jnp.int32(f0), jnp.int32(frames_per_lane))
            for f0 in range(0, frames_per_lane, fc)]
    be = sum(int(b) for b, _ in outs)
    fe = sum(int(f) for _, f in outs)
    return be, fe, lanes * frames_per_lane * code.block_length


def mc_stack(code: Code, lanes: int, frames_per_lane: int, seed, param,
             channel: str = "awgn", demapper: str = "soft", lane0: int = 0):
    return mc_sequential("stack", code, lanes, frames_per_lane, seed, param,
                         channel, demapper, lane0=lane0)


def mc_fano(code: Code, lanes: int, frames_per_lane: int, seed, param,
            channel: str = "awgn", demapper: str = "soft",
            timeout_per_bit: int = FANO_TIMEOUT, lane0: int = 0):
    return mc_sequential("fano", code, lanes, frames_per_lane, seed, param,
                         channel, demapper, timeout_per_bit, lane0)


if __name__ == "__main__":
    print(_register(jax.devices()[0].platform))
