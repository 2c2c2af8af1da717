"""Convolutional-code simulation and decoding framework.

A JAX/XLA framework with the full capabilities of the C
reference ``thomas-emig/convolutional-codes``: table-driven codebook,
shift-register convolutional encoder with tail termination, Gray-coded QAM
constellation mapper, AWGN / binary-symmetric channels with on-device RNG,
soft and hard demappers, and three decoder families (Viterbi, stack, Fano).

Design principles:
  * A code is *data* (trellis tables / tap integers), not behavior.
  * Every pipeline stage is a pure function over ``[batch, ...]`` arrays.
  * On the GPU the Monte-Carlo hot loops run as kernels: the fused Viterbi
    chain through Pallas/Triton, stack and Fano one frame per thread in
    CUDA; the plain XLA chains are the reference and the CPU path.
  * Monte-Carlo sweeps shard frames x SNR points over a ``jax.sharding.Mesh``
    with ``psum`` error aggregation; long frames use time-block trellis
    partitioning with state handoff.
"""

__version__ = "0.1.0"

from convolutional_codes.models.codebook import Code, get_code, register_code, list_codes

__all__ = ["Code", "get_code", "register_code", "list_codes", "__version__"]
