"""Complex-to-complex 1-D FFT.

Capability parity with the reference ``Clcfft`` (``cl_fft.h:29-70``,
``cl_fft.cpp:44-161``): power-of-two sizes, forward transform scaled by 1/N
(the reference folds the scaling into the final butterfly stage,
``cl_fft.cpp:39-40``), inverse transform unnormalized, f32 complex data.

The implementation is deliberately NOT a translation of the reference's
OpenCL launch structure (bit-reversal pass + log2(N) separate butterfly
dispatches, ``cl_fft.cpp:138-151``). Complex data is carried as a split
(re, im) pair of float arrays at the API; the paths are:

``auto``      The default: ``jnp.fft`` (cuFFT on a GPU, the host FFT
              library on the CPU) on complex64/complex128 data.
``xla``       The same ``jnp.fft`` route, named explicitly.
``mm``        Recursive Bailey four-step decomposition N = N1*N2 with dense
              DFT matrices at the leaves. A complex leaf DFT is ONE real
              matmul against the 2x2 block matrix [[U, V], [-V, U]];
              O(log_r N) passes instead of log2 N.
``stockham``  Radix-2 Stockham autosort: log2(N) fused self-sorting vector
              stages. Small-N path and exactness cross-check.
``flat``      Zero-transpose multi-level matmul chain (_fft_mm_flat) for
              sizes with a factor plan in _FLAT_PLANS; ``mm`` otherwise.

Non-power-of-two sizes run through ``jnp.fft`` on the ``auto``/``xla``
routes and through a Bluestein chirp-z on the matmul core otherwise
(beyond parity — the reference rounds sizes up instead). All paths are
batched over leading axes and jit-compatible (static shapes, no
data-dependent control flow).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.numerics import ilog2, is_pow2
from .cplx import Cplx, from_complex, to_complex

# Largest DFT leaf solved by a single dense matmul in the ``mm`` tree.
MAX_RADIX = 128

_HIGHEST = jax.lax.Precision.HIGHEST

# Matmul precision for the DFT leaves of the matmul paths (``mm``,
# ``flat``, ``stockham`` has none). The default ("auto") and "off" are
# HIGHEST: true float32 products. "on" asks for Precision.HIGH and
# "turbo" for Precision.DEFAULT on leaves >= _FAST_LEAF_MIN; on an H100
# both lower to TF32 tensor-core products (about three decimal digits
# per product — see set_fast_math). The default ``auto`` transform is
# jnp.fft and has no leaf matmuls.
_FAST_MODE = "auto"            # process-wide policy (set_fast_math)
_FAST_TLS = threading.local()  # per-thread override (exact_precision) —
#                                the realtime pipeline traces on a worker
#                                thread concurrently with the main thread,
#                                so the trace-scoped override must not leak
#                                across threads
_FAST_LEAF_MIN = 64


def _fast_mode() -> str:
    return getattr(_FAST_TLS, "mode", None) or _FAST_MODE


def set_fast_math(enabled: "Optional[bool] | str") -> None:
    """Leaf-matmul precision policy of the matmul FFT paths (impl="mm",
    "flat" and the Bluestein core on them).

    False / "off" and None / "auto" (the default) = full float32 leaves
    (Precision.HIGHEST). True / "on" = Precision.HIGH everywhere;
    "turbo" = Precision.DEFAULT for leaves >= 64. On an H100 both "on"
    and "turbo" lower to TF32 tensor-core products, an explicit accuracy
    trade (about 1e-3 relative error per matmul stage, against about
    1e-7 for float32) for spectral display / analysis workloads, in the
    spirit of ``PconvConfig(ring_dtype="bf16")``. The default transform
    (impl="auto", jnp.fft) has no leaf matmuls and is unaffected. The
    convolution engines are unaffected too: they wrap their internal
    transforms in ``exact_precision()``, which overrides any process
    mode."""
    global _FAST_MODE
    if isinstance(enabled, str):
        # strings must name a mode exactly — a truthy fallthrough would
        # turn set_fast_math("off") into reduced precision silently
        aliases = {"turbo": "turbo", "on": "on", "off": "off", "auto": "auto"}
        mode = aliases.get(enabled.lower())
        if mode is None:
            raise ValueError(
                f"set_fast_math: unknown mode {enabled!r} "
                f"(expected True/False/None or one of {sorted(aliases)})")
        _FAST_MODE = mode
        return
    _FAST_MODE = "auto" if enabled is None else ("on" if enabled else "off")


def _leaf_precision(n: int):
    mode = _fast_mode()
    if mode == "on":
        return jax.lax.Precision.HIGH
    if mode == "turbo":
        return (jax.lax.Precision.DEFAULT if n >= _FAST_LEAF_MIN
                else _HIGHEST)
    return _HIGHEST


@contextlib.contextmanager
def exact_precision():
    """Force full-f32 leaf matmuls inside the context (trace-time scope,
    THREAD-LOCAL — a concurrently tracing thread keeps its own policy).

    The streaming convolution engine wraps its internal transforms in
    this, so a process-wide set_fast_math never reaches them: reduced
    precision would break the engine's parity budget and its chunked ==
    sequential equivalence guarantee."""
    old = getattr(_FAST_TLS, "mode", None)
    _FAST_TLS.mode = "off"
    try:
        yield
    finally:
        _FAST_TLS.mode = old


# Factor plans for impl="flat": n -> factor tuple of the zero-transpose
# chain (_fft_mm_flat). Empty: every size takes the ``mm`` tree.
_FLAT_PLANS: dict = {}


# ---------------------------------------------------------------------------
# Host-precomputed tables (float64 trig, cast to f32 — same accuracy recipe
# as the reference's host-side twiddle fill, cl_fft.cpp:86-91).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _leaf_matrix_np(n: int, sign: int, npdt=np.float32) -> np.ndarray:
    """Real 2n x 2n block matrix for a complex n-point DFT in one matmul.

    With W[j,k] = exp(sign*2i*pi*j*k/n) = U + iV, the complex product
    (re + i im) @ W equals [re im] @ [[U, V], [-V, U]].
    """
    jk = np.outer(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64))
    w = np.exp(sign * 2j * np.pi * jk / n)
    u, v = w.real, w.imag
    top = np.concatenate([u, v], axis=1)
    bot = np.concatenate([-v, u], axis=1)
    return np.concatenate([top, bot], axis=0).astype(npdt)


@functools.lru_cache(maxsize=None)
def _leaf_gauss_np(n: int, sign: int, npdt=np.float32) -> Tuple[np.ndarray, ...]:
    """Gauss-trick matrices (U, U+V, V-U) for a 3-matmul complex DFT leaf.

    With W = U + iV and out_re = re@U - im@V, out_im = re@V + im@U:
        m1 = (re+im)@U,  m2 = im@(U+V),  m3 = re@(V-U)
        out_re = m1 - m2,  out_im = m1 + m3
    i.e. 3 real n x n matmuls instead of the one (2n x 2n) block matmul of
    _leaf_matrix_np — 25% fewer matmul FLOPs, for matmul-bound leaves
    under Precision.HIGH; gated by _GAUSS_MIN_N (off by default).
    """
    jk = np.outer(np.arange(n, dtype=np.float64), np.arange(n, dtype=np.float64))
    w = np.exp(sign * 2j * np.pi * jk / n)
    u, v = w.real, w.imag
    return u.astype(npdt), (u + v).astype(npdt), (v - u).astype(npdt)


@functools.lru_cache(maxsize=None)
def _fourstep_twiddle_np(n1: int, n2: int, sign: int, k1_major: bool = False,
                         npdt=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Four-step twiddle exp(sign*2i*pi*n2_idx*k1/N), split.

    Shape (n2, k1) by default, or (k1, n2) when k1_major (the
    transpose-free first-factor layout)."""
    n = n1 * n2
    if k1_major:
        ph = np.outer(np.arange(n1, dtype=np.float64),
                      np.arange(n2, dtype=np.float64))
    else:
        ph = np.outer(np.arange(n2, dtype=np.float64),
                      np.arange(n1, dtype=np.float64))
    w = np.exp(sign * 2j * np.pi * ph / n)
    return w.real.astype(npdt), w.imag.astype(npdt)


@functools.lru_cache(maxsize=None)
def _flat_twiddle_np(factors: Tuple[int, ...], lv: int, sign: int,
                     npdt=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Natural-order-output twiddle after level ``lv`` of a flat chain.

    With factors (f1..fL) and digits k_{lv+1}..k_1 already produced
    (axis order of the data at that point), the coupling of the NEXT
    input digit n_{lv+2} to everything produced so far is one table
        T[k_{lv+1}, ..., k_1, n] = exp(sign*2i*pi * kappa * n / P)
    where kappa = sum_j k_{j+1} * (f1*...*f_j) is the digit-composed
    output index so far and P = f1*...*f_{lv+2}. This is the same total
    phase as the recursive four-step's (root twiddle x inner twiddles),
    just partitioned per level so every multiply is elementwise in the
    flat chain's native layout (no transposes anywhere).
    """
    fs = factors
    shape = tuple(fs[j] for j in range(lv, -1, -1))     # (f_{lv+1},..,f1)
    kappa = np.zeros(shape, np.float64)
    for ax, j in enumerate(range(lv, -1, -1)):
        place = float(int(np.prod(fs[:j], dtype=np.int64)))
        idx = np.arange(fs[j], dtype=np.float64) * place
        bshape = [1] * len(shape)
        bshape[ax] = fs[j]
        kappa = kappa + idx.reshape(bshape)
    nnext = np.arange(fs[lv + 1], dtype=np.float64)
    P = float(int(np.prod(fs[:lv + 2], dtype=np.int64)))
    ph = kappa[..., None] * nnext / P
    w = np.exp(sign * 2j * np.pi * ph)
    return w.real.astype(npdt), w.imag.astype(npdt)


@functools.lru_cache(maxsize=None)
def _stage_twiddle_np(m: int, sign: int, npdt=np.float32
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Stockham stage twiddle w[j] = exp(sign*2i*pi*j/(2m)), j < m, split."""
    j = np.arange(m, dtype=np.float64)
    w = np.exp(sign * 2j * np.pi * j / (2 * m))
    return w.real.astype(npdt), w.imag.astype(npdt)


def _split_factors(n: int) -> Tuple[int, int]:
    """Balanced power-of-two factorization n = n1 * n2.

    Recurses both factors to leaves <= MAX_RADIX in O(log log n) levels
    (e.g. 2^20 -> (1024, 1024) -> (32, 32) leaves).
    """
    n1 = 1 << (ilog2(n) // 2)
    return n1, n // n1


# ---------------------------------------------------------------------------
# Implementation: recursive four-step matmul FFT
# ---------------------------------------------------------------------------

def _leaf_dft(re, im, sign, axis, gauss_min=None):
    """Dense complex DFT over `axis` (-1 or -2) as real matmuls.

    Two forms, both transpose-free for axis=-2 (the split planes
    concatenate/contract along the factor axis directly):

    - block: ONE (2n x 2n) matmul against [[U, V], [-V, U]] (4-matmul
      FLOPs, one concat read, one split write).
    - gauss: THREE n x n matmuls (_leaf_gauss_np; 25% fewer matmul FLOPs,
      a little more elementwise traffic), for Precision.HIGH leaves with
      n >= gauss_min (_GAUSS_MIN_N, off by default).
    """
    if gauss_min is None:
        gauss_min = _GAUSS_MIN_N
    n = re.shape[axis]
    npdt = np.dtype(re.dtype)
    prec = _HIGHEST if npdt == np.float64 else _leaf_precision(n)
    if prec == jax.lax.Precision.HIGH and n >= gauss_min:
        u, upv, vmu = (jnp.asarray(a) for a in _leaf_gauss_np(n, sign, npdt))
        eq = "...n,nk->...k" if axis == -1 else "...nj,nk->...kj"
        m1 = jnp.einsum(eq, re + im, u, precision=prec)
        m2 = jnp.einsum(eq, im, upv, precision=prec)
        m3 = jnp.einsum(eq, re, vmu, precision=prec)
        return m1 - m2, m1 + m3
    w = jnp.asarray(_leaf_matrix_np(n, sign, npdt))
    z = jnp.concatenate([re, im], axis=axis)
    if axis == -1:
        y = jnp.einsum("...n,nk->...k", z, w, precision=prec)
        return y[..., :n], y[..., n:]
    y = jnp.einsum("...nj,nk->...kj", z, w, precision=prec)
    return y[..., :n, :], y[..., n:, :]


def _leaf_dft_out_t(re, im, sign, gauss_min=None):
    """Dense DFT over the LAST axis, output transposed to (..., k, j).

    Fuses the four-step's final swapaxes into the second leaf matmul
    (einsum emits the transposed layout directly), saving one read+write
    pass over the working set. Off by default (_OUT_T_MIN_N2). Honors
    the same Gauss 3-matmul gate as _leaf_dft."""
    if gauss_min is None:
        gauss_min = _GAUSS_MIN_N
    n = re.shape[-1]
    npdt = np.dtype(re.dtype)
    prec = _HIGHEST if npdt == np.float64 else _leaf_precision(n)
    if prec == jax.lax.Precision.HIGH and n >= gauss_min:
        u, upv, vmu = (jnp.asarray(a) for a in _leaf_gauss_np(n, sign, npdt))
        eq = "...jn,nk->...kj"
        m1 = jnp.einsum(eq, re + im, u, precision=prec)
        m2 = jnp.einsum(eq, im, upv, precision=prec)
        m3 = jnp.einsum(eq, re, vmu, precision=prec)
        return m1 - m2, m1 + m3
    w = jnp.asarray(_leaf_matrix_np(n, sign, npdt))
    z = jnp.concatenate([re, im], axis=-1)
    y = jnp.einsum("...jn,nk->...kj", z, w, precision=prec)
    return y[..., :n, :], y[..., n:, :]


def _fft_mm(x: Cplx, sign: int) -> Cplx:
    """Unnormalized DFT over the last axis via recursive four-step
    matmuls (balanced factorization, dense leaves <= MAX_RADIX)."""
    re, im = x
    n = re.shape[-1]
    if n <= MAX_RADIX:
        return _leaf_dft(re, im, sign, -1)
    n1, n2 = _split_factors(n)
    batch = re.shape[:-1]

    def shape_to(a, trailing):
        return a.reshape(batch + trailing)

    re = shape_to(re, (n1, n2))
    im = shape_to(im, (n1, n2))
    if n1 <= MAX_RADIX and n1 >= _AXIS2_MIN_N1:
        # transpose-free first factor: contract n1 over axis -2 directly
        re, im = _leaf_dft(re, im, sign, -2)             # (..., k1, n2)
    else:
        re = jnp.swapaxes(re, -1, -2)                    # (..., n2, n1)
        im = jnp.swapaxes(im, -1, -2)
        re, im = _fft_mm((re, im), sign)                 # DFT over n1
        re = jnp.swapaxes(re, -1, -2)                    # (..., k1, n2)
        im = jnp.swapaxes(im, -1, -2)
    twr, twi = _fourstep_twiddle_np(n1, n2, sign, k1_major=True,
                                    npdt=np.dtype(re.dtype))
    twr, twi = jnp.asarray(twr), jnp.asarray(twi)
    re, im = re * twr - im * twi, re * twi + im * twr
    if n2 <= MAX_RADIX and n2 >= _OUT_T_MIN_N2:
        re, im = _leaf_dft_out_t(re, im, sign)           # (..., k2, k1)
    else:
        re, im = _fft_mm((re, im), sign)                 # DFT over n2
        re = jnp.swapaxes(re, -1, -2)                    # (..., k2, k1)
        im = jnp.swapaxes(im, -1, -2)
    return shape_to(re, (n,)), shape_to(im, (n,))


def _fft_mm_flat(x: Cplx, sign: int, factors: Tuple[int, ...],
                 gauss_min: Optional[int] = None) -> Cplx:
    """Zero-transpose multi-level DFT: operand-order dot_general chain.

    Same leaf matrices and total twiddle phase as the recursive four-step
    (_fft_mm), but the digit reordering that _fft_mm pays as explicit
    ``swapaxes`` passes is absorbed into the OUTPUT ORDER of each level's
    dot_general: the leaf matrix rides as a batch-broadcast LHS, so the
    fresh spectral digit lands immediately after the batch axis and the
    previously produced digits shift right — after the last level the
    layout is (b, k_L, ..., k_1) == natural order, with ZERO transpose
    passes: L levels == L fused passes total.

    Each factor must be a power-of-two dense leaf. Twiddles
    (_flat_twiddle_np) are elementwise in the chain's native layout and
    fuse into the adjacent dot. Honors the same per-leaf precision and
    Gauss 3-matmul gates as _fft_mm. Opt-in (impl="flat" with a plan in
    _FLAT_PLANS).
    """
    re, im = x
    n = re.shape[-1]
    assert int(np.prod(factors)) == n, (factors, n)
    if gauss_min is None:
        gauss_min = _GAUSS_MIN_N
    npdt = np.dtype(re.dtype)
    lead = re.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    L = len(factors)
    rest = n // factors[0]
    re = re.reshape(b, factors[0], rest)
    im = im.reshape(b, factors[0], rest)
    # loop invariant entering level lv: shape (b, k_lv, ..., k_1, f, R)
    # with f = factors[lv] the fresh input digit at axis 1+lv and R the
    # untransformed remainder (the R axis is absent once it reaches 1,
    # keeping the minor/lane dim a real factor, never a padded 1).
    for lv, f in enumerate(factors):
        prec = _HIGHEST if npdt == np.float64 else _leaf_precision(f)
        c_ax = 1 + lv
        dims = (((2,), (c_ax,)), ((0,), (0,)))
        if prec == jax.lax.Precision.HIGH and f >= gauss_min:
            u, upv, vmu = (jnp.broadcast_to(jnp.asarray(a), (b, f, f))
                           for a in _leaf_gauss_np(f, sign, npdt))
            m1 = jax.lax.dot_general(u, re + im, dims, precision=prec)
            m2 = jax.lax.dot_general(upv, im, dims, precision=prec)
            m3 = jax.lax.dot_general(vmu, re, dims, precision=prec)
            re, im = m1 - m2, m1 + m3
        else:
            # _leaf_matrix_np is the data-as-LHS block [[U, V], [-V, U]];
            # with the leaf as LHS the column form [[U, -V], [V, U]] is
            # needed — U, V are symmetric, so that is just the transpose.
            w = jnp.broadcast_to(
                jnp.asarray(_leaf_matrix_np(f, sign, npdt).T.copy()),
                (b, 2 * f, 2 * f))
            z = jnp.concatenate([re, im], axis=c_ax)
            y = jax.lax.dot_general(w, z, dims, precision=prec)
            re, im = jnp.split(y, 2, axis=1)
        # layout now (b, k_{lv+1}, k_lv, ..., k_1[, R]); split the next
        # input digit out of R and apply the level twiddle elementwise
        if lv + 1 < L:
            fnext = factors[lv + 1]
            dshape = (b,) + tuple(factors[j] for j in range(lv, -1, -1))
            rnext = re.shape[-1] // fnext if re.ndim == len(dshape) + 1 else 1
            twr, twi = _flat_twiddle_np(tuple(factors), lv, sign, npdt)
            if rnext > 1:
                re = re.reshape(dshape + (fnext, rnext))
                im = im.reshape(dshape + (fnext, rnext))
                twr = jnp.asarray(twr)[None, ..., None]
                twi = jnp.asarray(twi)[None, ..., None]
            else:
                re = re.reshape(dshape + (fnext,))
                im = im.reshape(dshape + (fnext,))
                twr = jnp.asarray(twr)[None, ...]
                twi = jnp.asarray(twi)[None, ...]
            re, im = re * twr - im * twi, re * twi + im * twr
    return re.reshape(lead + (n,)), im.reshape(lead + (n,))


# ---------------------------------------------------------------------------
# Implementation: radix-2 Stockham autosort
# ---------------------------------------------------------------------------

def _fft_stockham(x: Cplx, sign: int) -> Cplx:
    """Unnormalized DFT over the last axis, radix-2 DIF Stockham.

    Replaces the reference's bit-reversal + log2(N) butterfly dispatches
    (cl_fft.cpp:138-151) with log2(N) fused, self-sorting vector stages.
    """
    re, im = x
    n = re.shape[-1]
    stages = ilog2(n)
    batch = re.shape[:-1]
    re = re.reshape(batch + (1, n))
    im = im.reshape(batch + (1, n))
    m = n
    for _ in range(stages):
        m //= 2
        tr, ti = _stage_twiddle_np(m, sign, np.dtype(re.dtype))
        tr, ti = jnp.asarray(tr), jnp.asarray(ti)
        ar = re[..., :m] + re[..., m:]
        ai = im[..., :m] + im[..., m:]
        dr = re[..., :m] - re[..., m:]
        di = im[..., :m] - im[..., m:]
        br = dr * tr - di * ti
        bi = dr * ti + di * tr
        # New parity bit becomes the MSB of the row index => natural order out.
        rows = re.shape[-2] * 2
        re = jnp.stack([ar, br], axis=-3).reshape(batch + (rows, m))
        im = jnp.stack([ai, bi], axis=-3).reshape(batch + (rows, m))
    return re.reshape(batch + (n,)), im.reshape(batch + (n,))


# ---------------------------------------------------------------------------
# Implementation: Bluestein chirp-z for arbitrary (non-power-of-two) sizes.
# Beyond-parity capability: the reference is power-of-two only (its opcode
# layer rounds sizes up, csound/opcode.cpp:30-35).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bluestein_tables_np(n: int, sign: int, npdt=np.float32
                         ) -> Tuple[np.ndarray, ...]:
    """Chirp tables for an n-point DFT via an m-point circular convolution.

    With w = exp(sign*2i*pi/n): X[k] = c[k] * sum_n (x[n] c[n]) * conj_c[k-n]
    where c[j] = w^{j^2/2}. Phases use j^2 mod 2n in f64 to avoid large-angle
    trig error. Returns (chirp, B_spectrum) with m = np2(2n - 1).
    """
    m = 2
    while m < 2 * n - 1:
        m <<= 1
    j = np.arange(n, dtype=np.int64)
    phase = (j * j) % (2 * n)
    c = np.exp(sign * 1j * np.pi * phase.astype(np.float64) / n)
    b = np.zeros(m, np.complex128)
    b[:n] = np.conj(c)
    b[m - n + 1:] = np.conj(c[1:][::-1])          # b[-j] = conj(c[j])
    B = np.fft.fft(b)                             # host precompute, f64
    cdt = np.complex128 if np.dtype(npdt) == np.float64 else np.complex64
    return (c.astype(cdt), B.astype(cdt), m)


def _fft_bluestein(x: Cplx, sign: int, impl: str) -> Cplx:
    re, im = x
    n = re.shape[-1]
    c, B, m = _bluestein_tables_np(n, sign, np.dtype(re.dtype))
    cr, ci = jnp.asarray(c.real), jnp.asarray(c.imag)
    Br, Bi = jnp.asarray(B.real), jnp.asarray(B.imag)
    ar = re * cr - im * ci
    ai = re * ci + im * cr
    pad = [(0, 0)] * (ar.ndim - 1) + [(0, m - n)]
    Ar, Ai = _fft_dispatch((jnp.pad(ar, pad), jnp.pad(ai, pad)), -1, impl)
    Yr = Ar * Br - Ai * Bi
    Yi = Ar * Bi + Ai * Br
    yr, yi = _fft_dispatch((Yr, Yi), +1, impl)
    yr, yi = yr[..., :n] / m, yi[..., :n] / m
    return yr * cr - yi * ci, yr * ci + yi * cr


# ---------------------------------------------------------------------------
# Dispatcher + reference-normalized entry points
# ---------------------------------------------------------------------------


def _fft_dispatch(x: Cplx, sign: int, impl: str, scale: float = 1.0) -> Cplx:
    """Power-of-two dispatch (impl already validated); result is
    scale * DFT(x). On the XLA paths a trailing multiply fuses into the
    last pass."""
    if impl in ("mm", "flat"):
        flat_plan = _FLAT_PLANS.get(x[0].shape[-1])
        if impl == "flat" and flat_plan and len(flat_plan) >= 2:
            out = _fft_mm_flat(x, sign, tuple(flat_plan))
        else:
            # impl="flat" without a plan entry falls back to mm (the
            # Bluestein core also lands here for padded sizes)
            out = _fft_mm(x, sign)
    elif impl == "stockham":
        out = _fft_stockham(x, sign)
    else:
        out = _fft_xla(x, sign)
    if scale != 1.0:
        out = (out[0] * scale, out[1] * scale)
    return out


def _fft_xla(x: Cplx, sign: int) -> Cplx:
    """``jnp.fft`` on the complex view (any size)."""
    z = to_complex(x)
    n = x[0].shape[-1]
    z = jnp.fft.fft(z) if sign == -1 else jnp.fft.ifft(z) * n
    return from_complex(z)


_IMPLS = ("auto", "mm", "stockham", "xla", "flat")

# Contract the first four-step factor over axis -2 (transpose-free) only
# when the factor is at least this large; small factors (the streaming
# convolver's per-block transforms) keep the swapaxes recursion.
_AXIS2_MIN_N1 = 64

# Gauss-leaf threshold (see _leaf_dft): leaves >= this size use the
# 3-matmul complex product under Precision.HIGH. Off by default.
_GAUSS_MIN_N = 1 << 30

# Emit the second leaf factor's output pre-transposed (einsum
# "...jn,nk->...kj"), fusing the final swapaxes into the matmul. Off by
# default; kept as a tested alternative.
_OUT_T_MIN_N2 = 1 << 30


def fft_split(x: Cplx, sign: int, impl: str = "auto",
              scale: float = 1.0) -> Cplx:
    """Unnormalized DFT over the last axis on a split (re, im) pair.

    ``scale`` returns scale * DFT(x) with the multiply fused into the
    transform's last pass.

    This is the jit-facing core. sign = -1: forward; +1: inverse (sum
    convention). Data dtype is preserved for float32/float64 inputs
    (everything else is cast to float32): the f64 path is the analog of
    the reference's -DUSE_DOUBLE MYFLT-width build flag
    (macos-build.sh:5) — twiddle/leaf tables are built in f64 and all
    arithmetic stays f64. It requires jax_enable_x64 — see
    utils.numerics.require_x64.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown impl {impl!r}, expected one of {_IMPLS}")
    if sign not in (-1, 1):
        raise ValueError("sign must be -1 (forward) or +1 (inverse)")
    re = jnp.asarray(x[0])
    im = jnp.asarray(x[1])
    if re.dtype == jnp.float64 or im.dtype == jnp.float64:
        from ..utils.numerics import require_x64
        require_x64()
        re, im = re.astype(jnp.float64), im.astype(jnp.float64)
    else:
        re, im = re.astype(jnp.float32), im.astype(jnp.float32)
    if re.shape != im.shape:
        raise ValueError(f"re/im shapes differ: {re.shape} vs {im.shape}")
    n = re.shape[-1]
    if n < 1:
        raise ValueError("empty transform")
    if n == 1:
        return (re, im) if scale == 1.0 else (re * scale, im * scale)
    if impl == "auto":
        impl = "xla"
    if not is_pow2(n):
        # beyond-parity: arbitrary sizes via jnp.fft or Bluestein on the
        # power-of-two matmul core
        if impl == "xla":
            return _fft_dispatch((re, im), sign, impl, scale)
        out = _fft_bluestein((re, im), sign, impl)
        if scale != 1.0:
            out = (out[0] * scale, out[1] * scale)
        return out
    return _fft_dispatch((re, im), sign, impl, scale)


def fft_unnormalized(x: jax.Array, sign: int, impl: str = "auto") -> jax.Array:
    """Complex-array convenience wrapper around fft_split (host boundary)."""
    re, im = fft_split(from_complex(x), sign, impl)
    return to_complex((re, im))


def cfft_split(x: Cplx, forward: bool = True, impl: str = "auto") -> Cplx:
    """Reference-convention FFT on split data (Clcfft::transform parity).

    forward=True  -> DFT(x) / N   (scaling fused in the last stage in the
                                   reference, cl_fft.cpp:39-40)
    forward=False -> unnormalized inverse DFT (sum convention)

    Roundtrip cfft(cfft(x, True), False) == x.
    """
    n = jnp.shape(x[0])[-1]
    return fft_split(x, -1 if forward else +1, impl,
                     scale=1.0 / n if forward else 1.0)


def cfft(x: jax.Array, forward: bool = True, impl: str = "auto") -> jax.Array:
    """Complex-array wrapper for cfft_split. Direction is a call argument
    rather than baked into the object (SURVEY quirk Q7); the parity classes
    in api.py restore the per-object direction surface."""
    return to_complex(cfft_split(from_complex(x), forward, impl))


def fft(x: jax.Array, impl: str = "auto") -> jax.Array:
    """Standard-convention forward DFT (no scaling)."""
    return fft_unnormalized(x, -1, impl)


def ifft(x: jax.Array, impl: str = "auto") -> jax.Array:
    """Standard-convention inverse DFT (scaled by 1/N)."""
    return fft_unnormalized(x, +1, impl) / x.shape[-1]
