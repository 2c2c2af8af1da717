"""Device-mesh construction for sharded Monte-Carlo sweeps.

The framework uses two logical axes (SURVEY.md §2e):
  * ``frames`` — data parallelism over independent Monte-Carlo frames
    (the dominant axis; BER aggregation is a psum over it),
  * ``sweep``  — parallelism over sweep points (Eb/N0 / crossover values),
    each group of devices simulating a different channel quality.

Devices are laid out in plain ``jax.devices()`` order: the cards of one
host are joined all to all by NVLink, so no axis order is faster than
another.  Multi-host runs call ``jax.distributed.initialize`` before
:func:`make_mesh`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(shape: Optional[Dict[str, int]] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a named mesh.  Default: all devices on one ``frames`` axis.

    ``shape`` maps axis name → size, e.g. ``{"sweep": 2, "frames": 4}``.
    Sizes must multiply to the device count (a trailing -1 is inferred).
    """
    devs = list(devices) if devices is not None else jax.devices()
    n = len(devs)
    if shape is None:
        shape = {"frames": n}
    names = tuple(shape.keys())
    sizes = list(shape.values())
    if sizes.count(-1) == 1:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh shape {dict(zip(names, sizes))} does not "
                         f"match {n} devices")
    return Mesh(np.asarray(devs).reshape(tuple(sizes)), names)


def frames_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None or "frames" not in mesh.axis_names:
        return 1
    return mesh.shape["frames"]
