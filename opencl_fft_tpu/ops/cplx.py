"""Split-complex arithmetic: a complex tensor is a pair (re, im) of f32 arrays.

The split form is the API's representation of complex data: the matmul
FFT paths turn a complex matmul into one real matmul against a 2x2 block
matrix, and the packed real-spectrum conventions of the reference
(ops/rfft.py) are stated per plane. The default transform converts to
complex64 internally (ops/fft.py).

All functions are trivial element-wise ops that XLA fuses away.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Cplx = Tuple[jax.Array, jax.Array]


def cmul(a: Cplx, b: Cplx) -> Cplx:
    """(a.re + i a.im)(b.re + i b.im) — the `prod` helper, cl_fft.cpp:20-22."""
    ar, ai = a
    br, bi = b
    return ar * br - ai * bi, ar * bi + ai * br


def conj(a: Cplx) -> Cplx:
    ar, ai = a
    return ar, -ai


def rot(a: Cplx) -> Cplx:
    """Multiply by i — the `rot` helper, cl_fft.cpp:173-176."""
    ar, ai = a
    return -ai, ar


def cadd(a: Cplx, b: Cplx) -> Cplx:
    return a[0] + b[0], a[1] + b[1]


def csub(a: Cplx, b: Cplx) -> Cplx:
    return a[0] - b[0], a[1] - b[1]


def cscale(a: Cplx, s) -> Cplx:
    return a[0] * s, a[1] * s


def from_complex(x) -> Cplx:
    """Complex array (host or device) -> split pair.

    complex128/float64 inputs keep f64 planes (the USE_DOUBLE-parity path;
    only representable under jax_enable_x64 — otherwise jax has already
    demoted them), everything else becomes f32."""
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        dt = jnp.float64 if x.dtype == jnp.complex128 else jnp.float32
        return jnp.real(x).astype(dt), jnp.imag(x).astype(dt)
    dt = jnp.float64 if x.dtype == jnp.float64 else jnp.float32
    return x.astype(dt), jnp.zeros_like(x, dt)


def to_complex(a: Cplx):
    """Split pair -> complex array (use at the host boundary only).
    f64 planes produce complex128; anything else complex64."""
    re, im = jnp.asarray(a[0]), jnp.asarray(a[1])
    if re.dtype == jnp.float64 or im.dtype == jnp.float64:
        return jax.lax.complex(re.astype(jnp.float64), im.astype(jnp.float64))
    return jax.lax.complex(re.astype(jnp.float32), im.astype(jnp.float32))
