from convolutional_codes.sim.chain import make_point_step, make_uncoded_step
from convolutional_codes.sim.sweep import run_sweep, SweepSpec, PointRecord

__all__ = ["make_point_step", "make_uncoded_step", "run_sweep",
           "SweepSpec", "PointRecord"]
