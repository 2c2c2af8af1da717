"""The path-selection table (sim/paths.py) and the compile-cache placement
(utils/compile_cache.py)."""

import os

import jax
import pytest

from convolutional_codes.models.codebook import get_code
from convolutional_codes.sim.paths import (
    SEQUENTIAL_KERNEL, VITERBI_KERNEL, XLA, choose_path)
from convolutional_codes.utils import compile_cache

TABLE = [
    # (platform, code, channel, decoder, demapper, path)
    ("cpu", 0, "awgn", "viterbi", "soft", XLA),
    ("cpu", 0, "bsc", "stack", "soft", XLA),
    ("cpu", "k15-r14-16qam", "awgn", "fano", "soft", XLA),
    ("gpu", 0, "awgn", "viterbi", "soft", VITERBI_KERNEL),
    ("gpu", 0, "awgn", "viterbi", "hard", VITERBI_KERNEL),
    ("gpu", 0, "bsc", "viterbi", "soft", VITERBI_KERNEL),
    ("gpu", 5, "awgn", "viterbi", "soft", VITERBI_KERNEL),
    ("gpu", "nasa-k7", "awgn", "viterbi", "soft", VITERBI_KERNEL),
    ("gpu", "k9-r12", "awgn", "viterbi", "soft", XLA),        # 256 states
    ("gpu", 0, "awgn", "stack", "soft", SEQUENTIAL_KERNEL),
    ("gpu", 4, "bsc", "fano", "soft", SEQUENTIAL_KERNEL),     # WSPR K=32
    ("gpu", "k15-r14-16qam", "awgn", "fano", "soft", SEQUENTIAL_KERNEL),
    ("gpu", 0, "uncoded", "viterbi", "soft", XLA),
]


@pytest.mark.parametrize("platform,ck,channel,decoder,demapper,path", TABLE)
def test_choose_path_table(platform, ck, channel, decoder, demapper, path):
    assert choose_path(platform, get_code(ck), channel, decoder,
                       demapper) == path


def test_long_sequential_frames_fall_back_to_xla():
    code = get_code(0).replace(block_length=400)
    assert choose_path("gpu", code, "awgn", "stack", "soft") == XLA


@pytest.mark.parametrize("platform", ["metal", "rocm", ""])
def test_unknown_platform_is_an_error(platform):
    with pytest.raises(ValueError, match="unsupported platform"):
        choose_path(platform, get_code(0), "awgn", "viterbi", "soft")


def test_unknown_config_is_an_error():
    with pytest.raises(ValueError, match="unknown decoder"):
        choose_path("gpu", get_code(0), "awgn", "bcjr", "soft")
    with pytest.raises(ValueError, match="unknown channel"):
        choose_path("gpu", get_code(0), "rayleigh", "viterbi", "soft")


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(compile_cache.CHECKOUT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        # the same path every call: no temp names, pids or times
        assert compile_cache.enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
