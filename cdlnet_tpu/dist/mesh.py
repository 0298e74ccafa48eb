"""Device mesh construction from config.

The reference is single-device (train.py:15-16); scaling out is a from-
scratch subsystem here (SURVEY.md §2.5): a config mesh spec like
{"data": 4, "depth": 2} becomes a jax.sharding.Mesh whose axes the train
step and the halo-sharded forward consume by name. Collectives are
inserted by XLA (DP grad psum) or expressed as ppermute rings (depth
halos); user code never sees them.
"""

from __future__ import annotations

import math

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(spec: dict | None = None, devices=None) -> Mesh:
    """Build a Mesh from {axis_name: size}. Sizes must multiply to the device
    count; a single -1 axis is inferred. spec=None -> 1-D 'data' mesh over
    all devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if spec is None:
        spec = {"data": n}
    names = list(spec.keys())
    sizes = list(spec.values())
    if sizes.count(-1) == 1:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh spec {spec} does not match {n} devices")
    arr = np.asarray(devices).reshape(sizes)
    return Mesh(arr, axis_names=tuple(names))
