"""Numeric helpers shared across the framework.

Mirrors small host-side utilities of the reference:
  * ``np2`` — next power of two, reference ``csound/opcode.cpp:30-35``
    (note the reference returns at least 2 and rounds *up to or equal*).
  * bit-reversal permutation table, reference ``cl_fft.cpp:96-101``
    (kept for parity tests; the FFT paths here are autosorting and never
    materialise a bit-reversal pass).
"""

from __future__ import annotations

import numpy as np


def np2(n: int) -> int:
    """Next power of two >= n (minimum 2). Parity with csound/opcode.cpp:30-35."""
    v = 2
    while v < n:
        v <<= 1
    return v


def is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def ilog2(n: int) -> int:
    if not is_pow2(n):
        raise ValueError(f"size must be a power of two, got {n}")
    return n.bit_length() - 1


def bit_reverse_indices(n: int) -> np.ndarray:
    """Bit-reversed index table, identical construction to cl_fft.cpp:96-101.

    Only used by parity tests and the (non-default) radix-2 reference path;
    the Stockham/matmul FFTs are self-sorting.
    """
    if not is_pow2(n):
        raise ValueError(f"size must be a power of two, got {n}")
    bp = np.arange(n, dtype=np.int32)
    bp[:] = 0
    i = 1
    half = n // 2
    while i < n:
        for j in range(i):
            bp[i + j] = bp[j] + half
        i <<= 1
        half >>= 1
    return bp


def require_x64() -> None:
    """Raise unless jax is running with 64-bit types enabled.

    The f64 paths (the analog of the reference's -DUSE_DOUBLE MYFLT width,
    macos-build.sh:5) need jax_enable_x64; without it jax silently demotes
    float64 arrays to float32, which would make a requested-f64 transform
    quietly wrong rather than precise. The CPU and GPU backends both run
    f64.
    """
    import jax

    if not jax.config.jax_enable_x64:
        raise ValueError(
            "float64 data requires 64-bit mode: enable it with "
            "jax.config.update('jax_enable_x64', True) or the "
            "jax.enable_x64() context manager")
