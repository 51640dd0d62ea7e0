"""Distributed single-transform FFT: ONE large DFT sharded across chips.

``sharded_fft`` (sharded.py) scales the *batch* axis — zero communication.
This module scales the *transform itself*: the classic six-step
decomposition n = n1 * n2 with the transform data sharded over the mesh
and the three unavoidable global transposes expressed as XLA
``all_to_all`` collectives (NCCL over NVLink on GPUs), for
transforms too large (or too latency-critical) for a single device — a
capability with no reference counterpart (the reference is strictly
single-device, SURVEY §2 parallelism inventory).

Math (same decomposition as ops/fft._fft_mm, distributed):
    view x as (j1, j2) row-major;  X[k2*n1 + k1] =
      sum_{j2} W_n^{j2 k1} W_{n2}^{j2 k2} [ sum_{j1} x[j1,j2] W_{n1}^{j1 k1} ]
    transpose -> DFT(n1) -> twiddle -> transpose -> DFT(n2) -> transpose

Each transpose moves n/d elements per device (the minimum any distributed
FFT must exchange); the local DFTs run through ops.fft.fft_split.
Input and output are both natural order, contiguously
block-sharded over the mesh axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.cplx import Cplx
from ..ops.fft import _fourstep_twiddle_np, fft_split
from ..utils.numerics import ilog2, is_pow2


def _factor_for_mesh(n: int, d: int):
    """n = n1 * n2 with d dividing BOTH factors (each transpose reshards
    one axis over the mesh), n1 as close to sqrt(n) as that allows."""
    if not is_pow2(n):
        raise ValueError(f"distributed FFT needs a power-of-two size, got {n}")
    k = ilog2(n)
    n1 = 1 << (k // 2)
    while n1 < n and n1 % d:
        n1 <<= 1
    n2 = n // n1
    if n1 % d or n2 % d or n2 < 1:
        raise ValueError(
            f"cannot shard a {n}-point transform over {d} devices "
            f"(need d | n1 and d | n2)")
    return n1, n2


def dist_fft_split(x: Cplx, mesh: Mesh, axis: str = "tp", sign: int = -1,
                   impl: str = "auto") -> Cplx:
    """Single-transform DFT over the last axis, sharded over mesh axis
    ``axis``. x: split (..., n) pair; leading axes are replicated. Returns
    the natural-order spectrum with the same block-sharded layout.
    """
    re, im = jnp.asarray(x[0], jnp.float32), jnp.asarray(x[1], jnp.float32)
    n = re.shape[-1]
    d = mesh.shape[axis]
    n1, n2 = _factor_for_mesh(n, d)
    batch = re.shape[:-1]
    nb = len(batch)
    twr_np, twi_np = _fourstep_twiddle_np(n1, n2, sign)   # (n2, n1), j2-major

    spec_in = P(*([None] * nb + [axis]))

    @functools.partial(jax.shard_map, mesh=mesh,
                       in_specs=(spec_in, spec_in),
                       out_specs=(spec_in, spec_in))
    def run(re, im):
        my = jax.lax.axis_index(axis)

        def transpose(a):
            """Global transpose of (..., R/d, C) -> (..., C/d, R)."""
            a = jax.lax.all_to_all(a, axis, split_axis=nb + 1,
                                   concat_axis=nb, tiled=True)
            return jnp.swapaxes(a, -1, -2)

        r = re.reshape(batch + (n1 // d, n2))       # (j1 slice, j2)
        i = im.reshape(batch + (n1 // d, n2))
        r, i = transpose(r), transpose(i)           # (j2 slice, j1)
        r, i = fft_split((r, i), sign, impl)        # DFT over j1 -> k1
        rows = my * (n2 // d) + jnp.arange(n2 // d)  # global j2 indices
        twr = jnp.asarray(twr_np)[rows]              # (n2/d, n1)
        twi = jnp.asarray(twi_np)[rows]
        r, i = r * twr - i * twi, r * twi + i * twr
        r, i = transpose(r), transpose(i)           # (k1 slice, j2)
        r, i = fft_split((r, i), sign, impl)        # DFT over j2 -> k2
        r, i = transpose(r), transpose(i)           # (k2 slice, k1)
        return (r.reshape(batch + (n // d,)),
                i.reshape(batch + (n // d,)))

    return run(re, im)


def dist_fft(x, mesh: Mesh, axis: str = "tp", sign: int = -1,
             impl: str = "auto"):
    """Complex-array convenience wrapper (host boundary)."""
    from ..ops.cplx import from_complex, to_complex
    return to_complex(dist_fft_split(from_complex(x), mesh, axis, sign, impl))
