from convolutional_codes.parallel.mesh import make_mesh, frames_axis_size
from convolutional_codes.parallel.montecarlo import (
    sharded_accumulate, sweep_grid_accumulate, fused_mc_accumulate)
from convolutional_codes.parallel.streaming import (
    streaming_viterbi_decode, monolithic_reference_decode)

__all__ = ["make_mesh", "frames_axis_size", "sharded_accumulate",
           "sweep_grid_accumulate", "fused_mc_accumulate",
           "streaming_viterbi_decode", "monolithic_reference_decode"]
