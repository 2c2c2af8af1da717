"""The one place that decides which implementation runs a sweep point.

``choose_path`` maps (platform, code, channel, decoder, demapper) to a
path:

  * ``VITERBI_KERNEL``: the fused Viterbi Monte-Carlo kernel
    (ops/viterbi_mc.py), on the GPU for trellises it covers;
  * ``SEQUENTIAL_KERNEL``: stack and Fano one frame per thread
    (ops/sequential_mc.py), on the GPU for frames it holds;
  * ``XLA``: the plain chains of sim/chain.py, on the CPU and for every
    configuration no kernel covers.

Kernels run in interpret mode only where a test asks for it by argument,
never through this choice, and no path is chosen by catching a failure.
"""

from __future__ import annotations

import jax

from convolutional_codes.models.codebook import Code
from convolutional_codes.ops import sequential_mc, viterbi_mc

XLA = "xla"
VITERBI_KERNEL = "viterbi_kernel"
SEQUENTIAL_KERNEL = "sequential_kernel"

PLATFORMS = ("cpu", "gpu")


def current_platform() -> str:
    return jax.devices()[0].platform


def choose_path(platform: str, code: Code, channel: str, decoder: str,
                demapper: str) -> str:
    if platform not in PLATFORMS:
        raise ValueError(f"unsupported platform {platform!r}; "
                         f"expected one of {PLATFORMS}")
    if channel not in ("awgn", "bsc", "uncoded"):
        raise ValueError(f"unknown channel {channel!r}")
    if decoder not in ("viterbi", "stack", "fano"):
        raise ValueError(f"unknown decoder {decoder!r}")
    if demapper not in ("soft", "hard"):
        raise ValueError(f"unknown demapper {demapper!r}")
    if platform == "cpu" or channel == "uncoded":
        return XLA
    if decoder == "viterbi":
        return VITERBI_KERNEL if viterbi_mc.eligible(code) else XLA
    return SEQUENTIAL_KERNEL if sequential_mc.eligible(code) else XLA
