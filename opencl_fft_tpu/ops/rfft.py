"""Real <-> complex FFT with the reference's packed-spectrum convention.

Capability parity with ``Clrfft`` (``cl_fft.h:74-111``, ``cl_fft.cpp:208-296``):
an N-point real transform computed as an N/2-point complex FFT plus a
pack/unpack pass (the ``conv``/``iconv`` OpenCL kernels, ``cl_fft.cpp:178-205``,
and their frame-offset variants ``r2c``/``c2r`` in ``cl_conv_kernels.h:70-100``).

Packed-spectrum convention (M = N/2 complex bins):
  * bin 0 holds (DC/2, Nyquist/2) as (re, im) — ``cl_fft.cpp:181``;
  * bins 1..M-1 hold the usual non-negative-frequency spectrum, EXCEPT
  * bin M/2, which the reference kernels never touch (their thread range is
    i in [0, M/2)), leaving it as the raw half-size-FFT value = the
    conjugate of the true spectrum bin. Forward and inverse both skip the
    conjugation, so roundtrips and spectral products stay exact. We
    replicate this index range exactly (SURVEY §8: accidentally-consistent
    quirk).

The reference's forward object scales by 1/M inside the half-size complex
FFT (``cl_fft.cpp:39-40``); the partitioned-convolution engine instead runs
both directions unnormalized (``cl_conv_kernels.h:54-68``) — hence the
``unnormalized`` flag here.

Complex data is carried split as (re, im) float32 pairs (see ops/cplx.py);
complex-array wrappers are provided for the host boundary. All functions
are batched over leading axes and jit-compatible.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .cplx import Cplx, from_complex, to_complex
from .fft import fft_split

Float = jax.Array


@functools.lru_cache(maxsize=None)
def _half_twiddle_np(m: int, sign: int, npdt=np.float32
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """w2[i] = exp(sign * i*pi * idx / m), split — cl_fft.cpp:233-238 recipe."""
    i = np.arange(m, dtype=np.float64)
    w = np.exp(sign * 1j * np.pi * i / m)
    return w.real.astype(npdt), w.imag.astype(npdt)


def _flip(a: Float) -> Float:
    """a[(M - i) % M] over the last axis."""
    m = a.shape[-1]
    idx = (-jnp.arange(m)) % m
    return jnp.take(a, idx, axis=-1)


def pack_forward(c: Cplx) -> Cplx:
    """Forward pack: half-size FFT output -> packed real spectrum.

    Vectorized equivalent of the ``conv`` kernel (cl_fft.cpp:178-191): the
    pairwise (i, M-i) update is algebraically symmetric under i <-> M-i, so
    we evaluate the formula at every index at once, then restore the two
    special bins (0 and M/2).
    """
    re, im = c
    m = re.shape[-1]
    wr, wi = _half_twiddle_np(m, -1, np.dtype(re.dtype))
    wr, wi = jnp.asarray(wr), jnp.asarray(wi)
    fr, fi = _flip(re), _flip(im)          # cjs = (fr, -fi)
    er = 0.5 * (re + fr)
    ei = 0.5 * (im - fi)
    # o = 0.5 * rot(cjs - c);  rot(a) = i*a  (cl_fft.cpp:173-176)
    outr_ = 0.5 * (fi + im)
    outi_ = 0.5 * (fr - re)
    pr = wr * outr_ - wi * outi_
    pi = wr * outi_ + wi * outr_
    outr = er + pr
    outi = ei + pi
    dc = (re[..., 0] + im[..., 0]) * 0.5
    ny = (re[..., 0] - im[..., 0]) * 0.5
    outr = outr.at[..., 0].set(dc)
    outi = outi.at[..., 0].set(ny)
    if m >= 2:
        outr = outr.at[..., m // 2].set(re[..., m // 2])   # untouched bin
        outi = outi.at[..., m // 2].set(im[..., m // 2])
    return outr, outi


def unpack_inverse(c: Cplx) -> Cplx:
    """Inverse unpack: packed real spectrum -> half-size FFT input.

    Vectorized equivalent of the ``iconv`` kernel (cl_fft.cpp:192-205);
    note bin 0 has NO 0.5 factor on this side.
    """
    re, im = c
    m = re.shape[-1]
    wr, wi = _half_twiddle_np(m, +1, np.dtype(re.dtype))
    wr, wi = jnp.asarray(wr), jnp.asarray(wi)
    fr, fi = _flip(re), _flip(im)
    er = 0.5 * (re + fr)
    ei = 0.5 * (im - fi)
    # o = 0.5 * rot(c - cjs)
    outr_ = -0.5 * (im + fi)
    outi_ = 0.5 * (re - fr)
    pr = wr * outr_ - wi * outi_
    pi = wr * outi_ + wi * outr_
    outr = er + pr
    outi = ei + pi
    outr = outr.at[..., 0].set(re[..., 0] + im[..., 0])
    outi = outi.at[..., 0].set(re[..., 0] - im[..., 0])
    if m >= 2:
        outr = outr.at[..., m // 2].set(re[..., m // 2])
        outi = outi.at[..., m // 2].set(im[..., m // 2])
    return outr, outi


def deinterleave(r: Float) -> Cplx:
    """(..., N) reals -> split pair z[n] = r[2n] + i*r[2n+1].

    The 'reinterpret real buffer as complex' step of the reference
    (cl_fft.cpp:270, cl_conv.cpp:404-407). f64 input keeps f64 planes.
    """
    n = r.shape[-1]
    r = jnp.asarray(r)
    dt = jnp.float64 if r.dtype == jnp.float64 else jnp.float32
    r = r.astype(dt).reshape(r.shape[:-1] + (n // 2, 2))
    return r[..., 0], r[..., 1]


def interleave(z: Cplx) -> Float:
    """Inverse of deinterleave: split pair -> (..., 2M) reals."""
    re, im = z
    m = re.shape[-1]
    r = jnp.stack([re, im], axis=-1)
    return r.reshape(re.shape[:-1] + (2 * m,))


def rfft_split(r: Float, impl: str = "auto", unnormalized: bool = False) -> Cplx:
    """Forward real FFT, packed convention (Clrfft forward parity).

    r: (..., N) float32 -> split (..., N/2) packed spectrum.
    Default scales by 1/(N/2) like the reference's forward object; pass
    unnormalized=True for the partitioned-convolution convention.
    """
    n = r.shape[-1]
    if n < 4 or n % 4:
        # the packed convention needs an even number of complex bins
        # (M = n/2): bin M/2 is the self-conjugate bin the kernels leave
        # untouched (cl_fft.cpp:178-205). Odd M has no such bin, so sizes
        # with n % 4 != 0 would silently produce wrong spectra.
        raise ValueError(
            f"real FFT size must be a multiple of 4 (even complex bin "
            f"count) and >= 4, got {n}")
    z = deinterleave(r)
    # the 1/M normalization rides the transform's fused scale epilogue
    cr, ci = fft_split(z, -1, impl,
                       scale=1.0 if unnormalized else 2.0 / n)
    return pack_forward((cr, ci))


def irfft_split(c: Cplx, impl: str = "auto", scale: float = 1.0) -> Float:
    """Inverse real FFT, packed convention (Clrfft inverse parity).

    c: split (..., M) packed spectrum -> (..., 2M) float32 time data.
    Unnormalized inverse (reference convention): irfft(rfft(x)) == x when
    rfft used the default 1/M scaling. ``scale`` multiplies the result
    inside the transform's fused epilogue (see fft_split).
    """
    z = unpack_inverse(c)
    z = fft_split(z, +1, impl, scale=scale)
    return interleave(z)


def rfft(r: jax.Array, impl: str = "auto", unnormalized: bool = False) -> jax.Array:
    """Complex-array wrapper for rfft_split (host boundary)."""
    return to_complex(rfft_split(r, impl, unnormalized))


def irfft(c: jax.Array, impl: str = "auto") -> jax.Array:
    """Complex-array wrapper for irfft_split (host boundary)."""
    return irfft_split(from_complex(c), impl)


# ---------------------------------------------------------------------------
# Interop with the standard (numpy) rfft layout
# ---------------------------------------------------------------------------

def packed_to_standard(c: jax.Array) -> jax.Array:
    """Packed (M bins) -> standard rfft layout (M+1 bins, numpy convention).

    Inverts the reference packing: bin0 (re,im) = (DC/2, Nyq/2); bin M/2 is
    stored conjugated (the skipped conjugation described in the module doc).
    """
    c = jnp.asarray(c)
    m = c.shape[-1]
    full = jnp.concatenate([c, jnp.zeros(c.shape[:-1] + (1,), c.dtype)], axis=-1)
    full = full.at[..., 0].set((2.0 * c[..., 0].real).astype(c.dtype))
    full = full.at[..., m].set((2.0 * c[..., 0].imag).astype(c.dtype))
    full = full.at[..., m // 2].set(jnp.conj(c[..., m // 2]))
    return full


def standard_to_packed(s: jax.Array) -> jax.Array:
    """Standard rfft layout (M+1 bins) -> reference packed layout (M bins)."""
    s = jnp.asarray(s)
    m = s.shape[-1] - 1
    packed = s[..., :m]
    b0 = 0.5 * s[..., 0].real + 0.5j * s[..., m].real
    packed = packed.at[..., 0].set(b0.astype(s.dtype))
    packed = packed.at[..., m // 2].set(jnp.conj(s[..., m // 2]))
    return packed
