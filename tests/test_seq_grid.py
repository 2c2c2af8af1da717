"""Sequential Monte-Carlo points on the mesh (parallel/seq_grid.py).

A sharded run must be BIT-IDENTICAL to the serial same-seed
mc_fano/mc_stack run — not just statistically equal: every device hashes
a distinct lane0-offset block of the same global frame-id space, so the
per-point counters are exactly the serial ones (SURVEY §2e data + sweep
parallelism for the sequential decoders).
"""

import numpy as np
import pytest

from convolutional_codes.models.codebook import get_code
from convolutional_codes.ops.channels import awgn_sigma
from convolutional_codes.ops.sequential_mc import mc_fano, mc_stack
from convolutional_codes.parallel.mesh import make_mesh
from convolutional_codes.parallel.seq_grid import seq_mc_grid

pytestmark = pytest.mark.skipif(
    len(__import__("jax").devices()) < 8, reason="needs 8 virtual devices")


def test_fano_grid_matches_serial_two_points():
    code = get_code(0)
    param = float(awgn_sigma(2.0))
    kw = dict(channel="awgn", demapper="soft", timeout_per_bit=40)
    serial = [mc_fano(code, 64, 2, s, param, **kw) for s in (42, 43)]

    mesh = make_mesh({"sweep": 2, "frames": 4})
    be, fe, nb = seq_mc_grid("fano", code, 64, 2, [42, 43], [param, param],
                             mesh, channel="awgn", demapper="soft",
                             timeout_per_bit=40)
    for r in range(2):
        assert (int(be[r]), int(fe[r]), int(nb[r])) == serial[r]
    assert int(be.sum()) > 0


def test_fano_one_point_all_devices():
    """R=1: a single point's lanes split across the whole mesh."""
    code = get_code(0)
    param = float(awgn_sigma(2.0))
    kw = dict(channel="awgn", demapper="soft", timeout_per_bit=40)
    serial = mc_fano(code, 64, 2, 42, param, **kw)
    mesh = make_mesh({"sweep": 2, "frames": 4})
    be, fe, nb = seq_mc_grid("fano", code, 64, 2, [42], [param], mesh,
                             channel="awgn", demapper="soft",
                             timeout_per_bit=40)
    assert (int(be[0]), int(fe[0]), int(nb[0])) == serial


def test_stack_grid_matches_serial():
    code = get_code(0)
    serial = mc_stack(code, 64, 2, 7, 0.05, channel="bsc")
    mesh = make_mesh({"frames": 8})
    be, fe, nb = seq_mc_grid("stack", code, 64, 2, [7], [0.05], mesh,
                             channel="bsc")
    assert (int(be[0]), int(fe[0]), int(nb[0])) == serial
    assert int(be[0]) > 0


def test_points_with_distinct_params():
    """Per-point channel params land on the right device groups."""
    code = get_code(0)
    p_lo = float(awgn_sigma(0.0))    # noisy
    p_hi = float(awgn_sigma(8.0))    # clean
    mesh = make_mesh({"sweep": 2, "frames": 4})
    be, fe, nb = seq_mc_grid("fano", code, 32, 1, [5, 5], [p_lo, p_hi],
                             mesh, channel="awgn", timeout_per_bit=30)
    assert int(be[0]) > int(be[1])
