"""Device-mesh helpers.

The reference has no distributed execution — one OpenCL device chosen by
index (SURVEY §2 parallelism inventory). Scale-out here is first-class:
a 2-D ``(dp, tp)`` mesh where

  dp — data parallel: independent FFT/convolution channels (batch axis)
  tp — tensor parallel: the partition (frequency-delay-line) axis of the
       partitioned convolver, reduced with a psum across devices

Meshes are built over whatever devices exist (GPUs joined by NVLink, or
the virtual CPU mesh used in tests/dry runs).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              axis_names: Sequence[str] = ("dp", "tp"),
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a (dp, tp) mesh. Default shape: all devices on dp."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    arr = np.asarray(devices).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def balanced_shape(n: int) -> Tuple[int, int]:
    """Factor n devices into a near-square (dp, tp) grid."""
    dp = 1
    for d in range(int(np.sqrt(n)), 0, -1):
        if n % d == 0:
            dp = d
            break
    return dp, n // dp
