"""Uniform partitioned fast convolution (frequency-delay-line).

Capability parity with ``Clpconv`` (``cl_conv.h:124-188``, ``cl_conv.cpp``):
a length-``cvs`` convolution split into ``nparts = cvs/pts`` spectral
partitions processed against a frequency-delay line — O(L log P) per sample
with one-partition latency. Covers the LTI path (IR preloaded via
``push_ir``, ``cl_conv.cpp:353-388``), the streaming hot path
(``cl_conv.cpp:393-458``) and the time-varying path where both operands are
streamed (``cl_conv.cpp:460-548``).

Redesign for a batched accelerator (not a translation):
  * All streaming state is an explicit, device-resident pytree
    (``PconvState``) — the per-block host<->device copies of the reference
    (``cl_conv.cpp:399,455``) shrink to one ``pts``-sample block in/out, and
    checkpoint/resume is free (serialize the pytree).
  * The per-(partition x bin) ``convol`` kernel with CAS-loop float atomics
    (``cl_conv_kernels.h:102-118``) becomes a deterministic batched
    complex-MAC reduction over the partition axis — bitwise reproducible.
  * The reference's two OpenCL command queues for the two concurrent forward
    FFTs of time-varying convolution (``cl_conv.cpp:160-173,460-522``)
    become a single batched transform (leading dim 2): task parallelism via
    batching, not queues.
  * The log2(bins) sequential kernel launches per transform collapse into
    one fused jit region.

Normalization follows the reference exactly: unnormalized FFTs both ways,
single division by ``pts`` in the overlap-add (``cl_conv_kernels.h:120-124``).

Bin-0 note: the reference multiplies the packed (DC, Nyq) bin componentwise
(``cl_conv_kernels.h:114-115``). Because forward packing stores DC/2 and
Nyq/2 (``cl_conv_kernels.h:76``) while the inverse unpack expects half-scale
convention, the product of two half-scale values halves the DC and Nyquist
components of the *output* relative to true convolution. ``bin0_mode="exact"``
(default) restores the missing factor 2; ``bin0_mode="compat"`` reproduces
the reference bit-for-bit (SURVEY §8 policy: replicate documented behavior —
"convolution" — not the artifact, but keep the artifact reachable).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.numerics import is_pow2
from .cplx import Cplx
from .rfft import irfft_split, rfft_split

Float = jax.Array


@dataclasses.dataclass(frozen=True)
class PconvConfig:
    """Static configuration (the ctor args of Clpconv, cl_conv.cpp:140-143).

    pts:    partition size in samples (FFT size is 2*pts; bins = pts).
    nparts: number of partitions (= cvs / pts).
    bin0_mode: "exact" (true convolution) or "compat" (reference artifact).
    impl:   FFT implementation (see ops/fft.py).
    """

    pts: int
    nparts: int
    bin0_mode: str = "exact"
    impl: str = "auto"
    ring_dtype: str = "f32"  # spectral-ring storage: "f32" | "bf16"
    # bf16 halves the ring bandwidth (the streaming bottleneck for long
    # IRs) at ~1e-3 relative output error; products still accumulate in f32.
    dtype: str = "f32"     # compute width: "f32" | "f64" (USE_DOUBLE parity,
    # macos-build.sh:5). f64 needs jax_enable_x64.

    def __post_init__(self):
        if not is_pow2(self.pts) or self.pts < 2:
            raise ValueError(f"partition size must be a power of two >= 2, got {self.pts}")
        if self.nparts < 1:
            raise ValueError(f"need at least one partition, got {self.nparts}")
        if self.bin0_mode not in ("exact", "compat"):
            raise ValueError(f"bin0_mode must be 'exact' or 'compat', got {self.bin0_mode}")
        if self.ring_dtype not in ("f32", "bf16"):
            raise ValueError(f"ring_dtype must be 'f32'|'bf16', got {self.ring_dtype}")
        if self.dtype not in ("f32", "f64"):
            raise ValueError(f"dtype must be 'f32'|'f64', got {self.dtype}")
        if self.dtype == "f64" and self.ring_dtype != "f32":
            raise ValueError("f64 compute cannot use a reduced-width ring")

    @property
    def _jdtype(self):
        return jnp.float64 if self.dtype == "f64" else jnp.float32

    @property
    def _ring_jdtype(self):
        if self.ring_dtype == "bf16":
            return jnp.bfloat16
        return self._jdtype

    @property
    def bins(self) -> int:
        return self.pts

    @property
    def cvs(self) -> int:
        return self.pts * self.nparts

    @staticmethod
    def for_ir_length(cvs: int, pts: int, **kw) -> "PconvConfig":
        """Reference ctor arithmetic: nparts = cvs / pts (cl_conv.cpp:143)."""
        if pts <= 0 or cvs % pts:
            raise ValueError(f"convolution size {cvs} must be a multiple of pts {pts}")
        return PconvConfig(pts=pts, nparts=cvs // pts, **kw)


class PconvState(NamedTuple):
    """Device-resident streaming state (pytree).

    Mirrors the reference's persistent device buffers (cl_conv.h:126-129):
    spec1/spec2 spectral rings, olap tail, wp/wp2 write pointers — but as a
    serializable functional value.

    The input ring is stored DOUBLED (2*nparts rows; each frame written at
    wp and wp+nparts), so the per-block frequency-delay-line MAC reads one
    contiguous dynamic_slice window instead of a modulo gather. Costs one
    extra bins-row write per block.
    """

    spec_x_re: Float  # (2*nparts, bins) doubled input spectral ring
    spec_x_im: Float
    spec_h_re: Float  # (nparts, bins) IR / second-operand spectral ring
    spec_h_im: Float
    tail: Float       # (pts,) overlap-add tail (unnormalized)
    wp: Float         # () int32 — input ring pointer (increments)
    wp2: Float        # () int32 — coef ring pointer (decrements)


def pconv_init(cfg: PconvConfig) -> PconvState:
    """Zero state; wp = 0, wp2 = nparts - 1 (cl_conv.cpp:144)."""
    def z(rows):
        # distinct buffers per field: donation requires unaliased arguments
        return jnp.zeros((rows, cfg.bins), cfg._ring_jdtype)

    return PconvState(
        spec_x_re=z(2 * cfg.nparts), spec_x_im=z(2 * cfg.nparts),
        spec_h_re=z(cfg.nparts), spec_h_im=z(cfg.nparts),
        tail=jnp.zeros((cfg.pts,), cfg._jdtype),
        wp=jnp.asarray(0, jnp.int32),
        wp2=jnp.asarray(cfg.nparts - 1, jnp.int32),
    )


# Largest partition size whose forward transform runs as the one-matmul
# table below (8*pts^2 bytes of table: 8 MiB at pts=1024, 32 MiB at 2048).
_FWD_MM_MAX_PTS = 2048


@functools.lru_cache(maxsize=None)
def _pack_matrix_np(m: int) -> np.ndarray:
    """(2m, 2m) matrix U with [re | im] @ U == rfft.pack_forward of the
    split half-size spectrum.

    The pack is LINEAR in (re, im): the flip is a one-hot permutation,
    twiddles are diagonals and the special bins are column replacements,
    so the whole pass folds into one f64-precomputed matrix."""
    i = np.arange(m, dtype=np.float64)
    w = np.exp(-1j * np.pi * i / m)
    dr, di = np.diag(w.real), np.diag(w.imag)
    eye = np.eye(m)
    p = np.zeros((m, m))
    p[(-np.arange(m)) % m, np.arange(m)] = 1.0
    # pack_forward: outr_ = 0.5(fi+im) [im-part], outi_ = 0.5(fr-re)
    a_rr = 0.5 * (eye + p) - 0.5 * (p - eye) @ di
    a_ir = 0.5 * (p + eye) @ dr
    a_ri = 0.5 * (p - eye) @ dr
    a_ii = 0.5 * (eye - p) + 0.5 * (p + eye) @ di
    u = np.block([[a_rr, a_ri], [a_ir, a_ii]])
    u[:, 0] = 0.0                         # outr[0] = (re0 + im0) / 2
    u[:, m] = 0.0                         # outi[0] = (re0 - im0) / 2
    u[0, 0] = u[m, 0] = u[0, m] = 0.5
    u[m, m] = -0.5
    u[:, m // 2] = 0.0                    # untouched conjugate bin
    u[:, m + m // 2] = 0.0
    u[m // 2, m // 2] = 1.0
    u[m + m // 2, m + m // 2] = 1.0
    return u


@functools.lru_cache(maxsize=None)
def _wfwd_np(pts: int) -> np.ndarray:
    """(pts, 2*pts) matrix: block @ W == the ENTIRE unnormalized forward
    rFFT of the zero-padded frame (deinterleave + half-size DFT + pack),
    split [re | im]. Deinterleaving a zero-padded frame is a row
    selection of the split-complex DFT matrix, so the chain is one f64
    product."""
    m = pts
    jk = np.outer(np.arange(m, dtype=np.float64), np.arange(m, dtype=np.float64))
    w = np.exp(-2j * np.pi * jk / m)
    blockm = np.block([[w.real, w.imag], [-w.imag, w.real]])   # (2m, 2m) f64
    f = np.zeros((pts, 2 * m))
    k = np.arange(pts)
    f[k % 2 == 0] = blockm[(k[k % 2 == 0]) // 2]
    f[k % 2 == 1] = blockm[m + (k[k % 2 == 1] - 1) // 2]
    return (f @ _pack_matrix_np(m)).astype(np.float32)


def _forward_partition(cfg: PconvConfig, block: Float) -> Cplx:
    """Zero-padded unnormalized forward real FFT of (..., pts) blocks.

    The reference zero-pads implicitly: the reorder kernel zeroes the input
    buffer as it reads (cl_conv_kernels.h:51), so the second half of every
    2*pts-point frame is zero. Here the pad is explicit.

    For f32 engines with pts <= _FWD_MM_MAX_PTS and impl "auto"/"mm" the
    whole chain (zero-pad -> deinterleave -> half-size complex DFT ->
    pack) is ONE f64-precomputed (pts, 2*bins) matmul at full f32
    precision (HIGHEST: no TF32). It matches the transform chain to ~1e-6
    relative. An explicit impl="xla"/"stockham"/... runs the requested
    transform, matching the inverse side (irfft_split(acc, cfg.impl)).
    """
    from .fft import exact_precision

    if (cfg.bins == cfg.pts and cfg._jdtype == jnp.float32
            and cfg.pts <= _FWD_MM_MAX_PTS and cfg.impl in ("auto", "mm")):
        w = jnp.asarray(_wfwd_np(cfg.pts))
        z = jnp.dot(jnp.asarray(block, jnp.float32), w,
                    precision=jax.lax.Precision.HIGHEST)
        return z[..., :cfg.bins], z[..., cfg.bins:]
    pad = jnp.zeros(block.shape[:-1] + (cfg.pts,), cfg._jdtype)
    frame = jnp.concatenate([jnp.asarray(block, cfg._jdtype), pad], axis=-1)
    with exact_precision():
        return rfft_split(frame, cfg.impl, unnormalized=True)


def push_ir(cfg: PconvConfig, state: PconvState, ir: Float) -> PconvState:
    """Analyze an impulse response into the coefficient ring.

    Parity with Clpconv::push_ir (cl_conv.cpp:353-388): partitions are
    written at wp2, wp2 decrementing, so after nparts writes the ring holds
    the IR partitions in REVERSE order and wp2 is back where it started —
    the ordering that lets the MAC walk input frames forward
    (cl_conv_kernels.h:104-113).
    """
    ir = jnp.asarray(ir, cfg._jdtype)
    if ir.shape != (cfg.cvs,):
        raise ValueError(f"IR must have shape ({cfg.cvs},), got {ir.shape}")
    parts = ir.reshape(cfg.nparts, cfg.pts)
    hr, hi = _forward_partition(cfg, parts)          # (nparts, bins) batched
    slots = (state.wp2 - jnp.arange(cfg.nparts)) % cfg.nparts
    return state._replace(
        spec_h_re=state.spec_h_re.at[slots].set(hr.astype(state.spec_h_re.dtype)),
        spec_h_im=state.spec_h_im.at[slots].set(hi.astype(state.spec_h_im.dtype)),
        # wp2 decremented nparts times == unchanged (mod nparts)
    )


def _spectral_mac(cfg: PconvConfig, state: PconvState, rp: Float) -> Cplx:
    """Frequency-delay-line MAC: sum over partitions of in[(rp+q) % np] * coef[q].

    Deterministic tree reduction replacing the AtomicAdd accumulation of the
    ``convol`` kernel (cl_conv_kernels.h:102-118). Bin 0 is the packed
    (DC, Nyq) pair and multiplies componentwise (``:114-115``).
    """
    np_ = cfg.nparts
    b0_scale = 2.0 if cfg.bin0_mode == "exact" else 1.0
    # doubled ring: rows [rp, rp+nparts) are exactly frames (rp+q) % nparts
    f32 = cfg._jdtype
    z = jnp.asarray(0, rp.dtype)
    xr = jax.lax.dynamic_slice(state.spec_x_re, (rp, z), (np_, cfg.bins)).astype(f32)
    xi = jax.lax.dynamic_slice(state.spec_x_im, (rp, z), (np_, cfg.bins)).astype(f32)
    hr = state.spec_h_re.astype(f32)
    hi = state.spec_h_im.astype(f32)
    acc_r = jnp.sum(xr * hr - xi * hi, axis=0)
    acc_i = jnp.sum(xr * hi + xi * hr, axis=0)
    acc_r = acc_r.at[0].set(b0_scale * jnp.sum(xr[:, 0] * hr[:, 0]))
    acc_i = acc_i.at[0].set(b0_scale * jnp.sum(xi[:, 0] * hi[:, 0]))
    return acc_r, acc_i


def _inverse_and_ola(cfg: PconvConfig, state: PconvState, acc: Cplx
                     ) -> Tuple[Float, Float]:
    """Inverse transform + overlap-add; returns (out_block, new_tail).

    out = (ifft_first_half + tail) / pts ; new tail = second half —
    cl_conv_kernels.h:120-124 (the /parts division IS the inverse-FFT
    normalization, deferred to the last step).
    """
    from .fft import exact_precision

    with exact_precision():
        y = irfft_split(acc, cfg.impl)               # (2*pts,) reals
    out = (y[..., : cfg.pts] + state.tail) / cfg.pts
    return out, y[..., cfg.pts:]


def _mac_inverse_ola(cfg: PconvConfig, state: PconvState, rp: Float
                     ) -> Tuple[Float, Float]:
    """MAC + inverse + overlap-add."""
    acc = _spectral_mac(cfg, state, rp)
    return _inverse_and_ola(cfg, state, acc)


def _ring_write2(ring: Float, row: Float, wp: Float, nparts: int) -> Float:
    """Write one frame into the doubled ring: at wp and wp + nparts."""
    row = row.astype(ring.dtype)[None]
    z = jnp.asarray(0, wp.dtype)      # match wp's int width (x64 mode)
    ring = jax.lax.dynamic_update_slice(ring, row, (wp, z))
    return jax.lax.dynamic_update_slice(ring, row, (wp + nparts, z))


def pconv_step(cfg: PconvConfig, state: PconvState, block: Float
               ) -> Tuple[PconvState, Float]:
    """One LTI streaming block: Clpconv::convolution(out, in) parity
    (cl_conv.cpp:393-458). block: (pts,) -> out: (pts,)."""
    xr, xi = _forward_partition(cfg, block)
    spec_x_re = _ring_write2(state.spec_x_re, xr, state.wp, cfg.nparts)
    spec_x_im = _ring_write2(state.spec_x_im, xi, state.wp, cfg.nparts)
    wp = (state.wp + 1) % cfg.nparts                  # cl_conv.cpp:424
    state = state._replace(spec_x_re=spec_x_re, spec_x_im=spec_x_im, wp=wp)
    out, tail = _mac_inverse_ola(cfg, state, wp)      # rp = post-increment wp
    return state._replace(tail=tail), out


def pconv_step_tv(cfg: PconvConfig, state: PconvState, block_x: Float,
                  block_h: Float) -> Tuple[PconvState, Float]:
    """One time-varying block: Clpconv::convolution(out, in1, in2) parity
    (cl_conv.cpp:460-548). The reference's dual command queues become one
    batched forward transform (leading dim 2)."""
    both = jnp.stack([jnp.asarray(block_x, cfg._jdtype),
                      jnp.asarray(block_h, cfg._jdtype)])
    fr, fi = _forward_partition(cfg, both)            # (2, bins) [tv]
    spec_x_re = _ring_write2(state.spec_x_re, fr[0], state.wp, cfg.nparts)
    spec_x_im = _ring_write2(state.spec_x_im, fi[0], state.wp, cfg.nparts)
    z0 = jnp.asarray(0, state.wp2.dtype)
    spec_h_re = jax.lax.dynamic_update_slice(
        state.spec_h_re, fr[1].astype(state.spec_h_re.dtype)[None], (state.wp2, z0))
    spec_h_im = jax.lax.dynamic_update_slice(
        state.spec_h_im, fi[1].astype(state.spec_h_im.dtype)[None], (state.wp2, z0))
    wp = (state.wp + 1) % cfg.nparts                  # cl_conv.cpp:516
    wp2 = (state.wp2 - 1) % cfg.nparts                # cl_conv.cpp:519
    state = state._replace(
        spec_x_re=spec_x_re, spec_x_im=spec_x_im,
        spec_h_re=spec_h_re, spec_h_im=spec_h_im, wp=wp, wp2=wp2,
    )
    out, tail = _mac_inverse_ola(cfg, state, wp)
    return state._replace(tail=tail), out


class XfadeState(NamedTuple):
    """In-progress click-free IR replacement (see pconv_begin_xfade).

    ``state`` carries the shared input spectral ring, the INCOMING IR's
    coefficient ring, and the incoming path's OLA tail; the outgoing IR's
    coefficients and tail ride alongside until the fade completes.
    """

    state: PconvState
    old_h_re: Float   # (nparts, bins) outgoing coefficient ring
    old_h_im: Float
    old_tail: Float   # (pts,) outgoing-path OLA tail


def pconv_begin_xfade(cfg: PconvConfig, state: PconvState, new_ir: Float
                      ) -> XfadeState:
    """Begin a crossfaded IR replacement on a live LTI stream.

    The reference's ``push_ir`` (cl_conv.cpp:353-388) replaces the
    coefficient ring instantly — on a live stream that is a click. This
    (beyond-parity) path keeps BOTH coefficient rings and blends the two
    convolutions over a caller-chosen window (pconv_step_xfade).

    The incoming path's OLA tail is reconstructed exactly by re-running
    the previous block's MAC + inverse against the new coefficients over
    the retained input ring (the frequency-delay line already holds the
    full dependency window), so from the first faded sample the output
    equals (1-r)·conv(x, old_ir) + r·conv(x, new_ir) over the WHOLE input
    history — no transient beyond the fade itself.
    """
    new_state = push_ir(cfg, state, new_ir)
    acc = _spectral_mac(cfg, new_state, state.wp)
    _, tail_new = _inverse_and_ola(cfg, new_state, acc)
    return XfadeState(state=new_state._replace(tail=tail_new),
                      old_h_re=state.spec_h_re, old_h_im=state.spec_h_im,
                      old_tail=state.tail)


def pconv_step_xfade(cfg: PconvConfig, xf: XfadeState, block: Float,
                     ramp: Float) -> Tuple[XfadeState, Float]:
    """One LTI block during a crossfaded IR replacement.

    ``ramp``: (pts,) blend weights in [0, 1] for the incoming IR (0 = all
    outgoing, 1 = all incoming). Both paths share one forward transform
    and one input-ring write; each keeps its own OLA tail, so both
    convolutions stay exact throughout the fade. Once the ramp has reached
    1, continue with ``xf.state`` via pconv_step and drop the rest.
    """
    st = xf.state
    xr, xi = _forward_partition(cfg, block)
    st = st._replace(
        spec_x_re=_ring_write2(st.spec_x_re, xr, st.wp, cfg.nparts),
        spec_x_im=_ring_write2(st.spec_x_im, xi, st.wp, cfg.nparts),
        wp=(st.wp + 1) % cfg.nparts)
    out_new, tail_new = _mac_inverse_ola(cfg, st, st.wp)
    st_old = st._replace(spec_h_re=xf.old_h_re, spec_h_im=xf.old_h_im,
                         tail=xf.old_tail)
    out_old, tail_old = _mac_inverse_ola(cfg, st_old, st.wp)
    ramp = jnp.asarray(ramp, out_new.dtype)
    out = out_old + ramp * (out_new - out_old)
    return XfadeState(state=st._replace(tail=tail_new),
                      old_h_re=xf.old_h_re, old_h_im=xf.old_h_im,
                      old_tail=tail_old), out


def pconv_chunk(cfg: PconvConfig, state: PconvState, blocks: Float
                ) -> Tuple[PconvState, Float]:
    """Process K consecutive LTI blocks in one fused call (K <= nparts).

    Equal to K sequential pconv_step calls to f32 rounding: bit-equal when
    both run op by op on the CPU backend (tests/test_pconv.py), 3.0e-7 of
    max|out| apart when both are jitted on an H100 (chip_smoke.py), where
    the batched transforms round differently. Uses one batched
    forward/inverse transform pair and a vectorized overlap-add — the
    middle ground between per-block streaming (pts-sample latency) and
    convolve_oneshot (whole-signal latency). Latency becomes K blocks.

    Derivation: the sequential MAC (cl_conv_kernels.h:102-118 pairing)
    reduces to out_t = sum_j H[j] (*) S_{t-(nparts-1)+j}, i.e. a sliding
    complex dot of the stored coefficient frames against the frame
    timeline; a K-chunk needs the nparts-1 previous frames (from the ring)
    plus the K new ones.
    """
    blocks = jnp.asarray(blocks, cfg._jdtype)
    k = blocks.shape[0]
    np_ = cfg.nparts
    if k < 1 or k > np_:
        raise ValueError(f"chunk size must be in [1, nparts={np_}], got {k}")
    f32 = cfg._jdtype

    fr, fi = _forward_partition(cfg, blocks)           # (K, bins)
    # round fresh frames through the ring dtype FIRST: sequential steps
    # read them back quantized from the ring, so the chunk MAC must see
    # the same values for bit-equivalence (no-op for f32 rings)
    fr = fr.astype(cfg._ring_jdtype).astype(f32)
    fi = fi.astype(cfg._ring_jdtype).astype(f32)

    # timeline C: nparts-1 most recent old frames (ascending time) + new.
    # Old frame t0-1-m lives at ring slot (wp-1-m) % np; ascending time
    # order is slots (wp+1+i) % np, i = 0..np-2 — one contiguous window of
    # the doubled ring starting at row wp+1.
    def timeline(plane2, new):
        old = jax.lax.dynamic_slice(
            plane2, (state.wp + 1, jnp.asarray(0, state.wp.dtype)),
            (np_ - 1, cfg.bins)).astype(f32)
        return jnp.concatenate([old, new], axis=0)     # (np-1+K, bins)

    cr = timeline(state.spec_x_re, fr)
    ci = timeline(state.spec_x_im, fi)
    hr = state.spec_h_re.astype(f32)
    hi = state.spec_h_im.astype(f32)
    b0 = 2.0 if cfg.bin0_mode == "exact" else 1.0

    # one batched sliding-window MAC: windows[k, q] = timeline[k + q],
    # acc[k] = sum_q windows[k, q] (*) h[q] — replaces the K-iteration
    # Python loop (K separate MAC+reduce chains) with a single gather +
    # broadcast-multiply + reduce, with the same multiply-then-sum
    # structure as the sequential MAC.
    widx = jnp.arange(k)[:, None] + jnp.arange(np_)[None, :]   # (K, np)
    wr = jnp.take(cr, widx, axis=0)                            # (K, np, bins)
    wi = jnp.take(ci, widx, axis=0)
    accs_r = jnp.sum(wr * hr[None] - wi * hi[None], axis=1)    # (K, bins)
    accs_i = jnp.sum(wr * hi[None] + wi * hr[None], axis=1)
    accs_r = accs_r.at[:, 0].set(
        b0 * jnp.sum(wr[:, :, 0] * hr[None, :, 0], axis=1))
    accs_i = accs_i.at[:, 0].set(
        b0 * jnp.sum(wi[:, :, 0] * hi[None, :, 0], axis=1))

    from .fft import exact_precision
    with exact_precision():
        y = irfft_split((accs_r, accs_i), cfg.impl)            # (K, 2pts)
    tails = jnp.concatenate([state.tail[None], y[:-1, cfg.pts:]], axis=0)
    outs = (y[:, : cfg.pts] + tails) / cfg.pts

    # ring update: frame kk lands at slot (wp+kk) % np (doubled write);
    # slots within a chunk are distinct (K <= nparts), one batched scatter
    slots = (state.wp + jnp.arange(k)) % np_
    frq = fr.astype(state.spec_x_re.dtype)
    fiq = fi.astype(state.spec_x_im.dtype)
    sxr = state.spec_x_re.at[slots].set(frq).at[slots + np_].set(frq)
    sxi = state.spec_x_im.at[slots].set(fiq).at[slots + np_].set(fiq)
    return state._replace(spec_x_re=sxr, spec_x_im=sxi,
                          wp=(state.wp + k) % np_,
                          tail=y[-1, cfg.pts:]), outs


def pconv_chunk_tv(cfg: PconvConfig, state: PconvState, blocks_x: Float,
                   blocks_h: Float) -> Tuple[PconvState, Float]:
    """Process K consecutive TIME-VARYING blocks in one fused call.

    Equal to K sequential pconv_step_tv calls to f32 rounding (see
    pconv_chunk). The input-ring
    timeline works exactly as in pconv_chunk; the coefficient ring rotates
    the other way (wp2--, cl_conv.cpp:519), so for block k of the chunk,
    slot q holds the chunk's own h-frame d = (wp2 - q) mod nparts when
    d <= k, and the pre-chunk ring content otherwise.
    """
    blocks_x = jnp.asarray(blocks_x, cfg._jdtype)
    blocks_h = jnp.asarray(blocks_h, cfg._jdtype)
    k = blocks_x.shape[0]
    np_ = cfg.nparts
    if k < 1 or k > np_:
        raise ValueError(f"chunk size must be in [1, nparts={np_}], got {k}")
    if blocks_h.shape != blocks_x.shape:
        raise ValueError("operand block arrays must have identical shapes")
    f32 = cfg._jdtype

    both = jnp.stack([blocks_x, blocks_h], axis=1)       # (K, 2, pts)
    fr, fi = _forward_partition(cfg, both)               # (K, 2, bins)
    # ring-dtype quantization first — see pconv_chunk
    fr = fr.astype(cfg._ring_jdtype).astype(f32)
    fi = fi.astype(cfg._ring_jdtype).astype(f32)
    fxr, fxi = fr[:, 0], fi[:, 0]
    fhr, fhi = fr[:, 1], fi[:, 1]

    def timeline(plane2, new):
        old = jax.lax.dynamic_slice(
            plane2, (state.wp + 1, jnp.asarray(0, state.wp.dtype)),
            (np_ - 1, cfg.bins)).astype(f32)
        return jnp.concatenate([old, new], axis=0)

    cr = timeline(state.spec_x_re, fxr)
    ci = timeline(state.spec_x_im, fxi)

    # coefficient-frame selection: slot q's chunk-local write time
    d = (state.wp2 - jnp.arange(np_)) % np_              # (np,)
    dcl = jnp.clip(d, 0, k - 1)
    hnew_r = jnp.take(fhr, dcl, axis=0)                  # (np, bins)
    hnew_i = jnp.take(fhi, dcl, axis=0)
    hold_r = state.spec_h_re.astype(f32)
    hold_i = state.spec_h_im.astype(f32)
    b0 = 2.0 if cfg.bin0_mode == "exact" else 1.0

    # batched sliding-window MAC with a per-k coefficient selection mask:
    # at chunk-local time k, slot q holds the chunk's own h-frame when its
    # write time d[q] <= k, else the pre-chunk ring content. One gather +
    # masked select + reduce replaces the K-iteration Python loop.
    widx = jnp.arange(k)[:, None] + jnp.arange(np_)[None, :]     # (K, np)
    wr = jnp.take(cr, widx, axis=0)                              # (K, np, bins)
    wi = jnp.take(ci, widx, axis=0)
    sel = (d[None, :] <= jnp.arange(k)[:, None])[:, :, None]     # (K, np, 1)
    hrk = jnp.where(sel, hnew_r[None], hold_r[None])             # (K, np, bins)
    hik = jnp.where(sel, hnew_i[None], hold_i[None])
    accs_r = jnp.sum(wr * hrk - wi * hik, axis=1)                # (K, bins)
    accs_i = jnp.sum(wr * hik + wi * hrk, axis=1)
    accs_r = accs_r.at[:, 0].set(
        b0 * jnp.sum(wr[:, :, 0] * hrk[:, :, 0], axis=1))
    accs_i = accs_i.at[:, 0].set(
        b0 * jnp.sum(wi[:, :, 0] * hik[:, :, 0], axis=1))

    from .fft import exact_precision
    with exact_precision():
        y = irfft_split((accs_r, accs_i), cfg.impl)
    tails = jnp.concatenate([state.tail[None], y[:-1, cfg.pts:]], axis=0)
    outs = (y[:, : cfg.pts] + tails) / cfg.pts

    slots = (state.wp + jnp.arange(k)) % np_
    fxq = fxr.astype(state.spec_x_re.dtype)
    fyq = fxi.astype(state.spec_x_im.dtype)
    sxr = state.spec_x_re.at[slots].set(fxq).at[slots + np_].set(fxq)
    sxi = state.spec_x_im.at[slots].set(fyq).at[slots + np_].set(fyq)
    sel = (d <= k - 1)[:, None]
    shr = jnp.where(sel, hnew_r.astype(state.spec_h_re.dtype), state.spec_h_re)
    shi = jnp.where(sel, hnew_i.astype(state.spec_h_im.dtype), state.spec_h_im)
    return state._replace(
        spec_x_re=sxr, spec_x_im=sxi, spec_h_re=shr, spec_h_im=shi,
        wp=(state.wp + k) % np_, wp2=(state.wp2 - k) % np_,
        tail=y[-1, cfg.pts:]), outs


# ---------------------------------------------------------------------------
# Batch conveniences (scan over blocks) — the "offline" view used by tests,
# benchmarks and the models layer.
# ---------------------------------------------------------------------------

def pconv_stream(cfg: PconvConfig, state: PconvState, blocks: Float,
                 unroll: int = 8) -> Tuple[PconvState, Float]:
    """Run many LTI blocks through a lax.scan. blocks: (nblocks, pts).

    ``unroll`` places several blocks in one loop iteration, amortizing
    the per-iteration loop overhead while per-block work is small."""
    def body(st, blk):
        return pconv_step(cfg, st, blk)
    return jax.lax.scan(body, state, blocks, unroll=unroll)


def pconv_stream_tv(cfg: PconvConfig, state: PconvState, blocks_x: Float,
                    blocks_h: Float, unroll: int = 8) -> Tuple[PconvState, Float]:
    """Run many TV blocks through a lax.scan (see pconv_stream)."""
    def body(st, blks):
        return pconv_step_tv(cfg, st, blks[0], blks[1])
    stacked = jnp.stack([blocks_x, blocks_h], axis=1)  # (nblocks, 2, pts)
    return jax.lax.scan(body, state, stacked, unroll=unroll)


def _batched_scan(step, cfg: PconvConfig, state: PconvState, blocks,
                  unroll: int) -> Tuple[PconvState, Float]:
    """Scan ``step`` over (nblocks, B, ...) block stacks, vmapped over the
    channel axis of every state field.

    Ring pointers may be shared scalars (models.convolver.batched_state
    layout) or per-channel vectors; the latter map through vmap."""
    # scan unroll amortizes the loop overhead only while per-block work is
    # tiny; at wide batches the unrolled program grows instead
    if jax.tree.leaves(blocks)[0].shape[1] >= 16:
        unroll = 1
    wp_ax = 0 if jnp.ndim(state.wp) else None
    wp2_ax = 0 if jnp.ndim(state.wp2) else None

    def body(st, blks):
        def one(xr, xi, hr, hi, tl, wp, wp2, *blk):
            sub = st._replace(spec_x_re=xr, spec_x_im=xi, spec_h_re=hr,
                              spec_h_im=hi, tail=tl, wp=wp, wp2=wp2)
            out_st, out = step(cfg, sub, *blk)
            return (out_st.spec_x_re, out_st.spec_x_im, out_st.spec_h_re,
                    out_st.spec_h_im, out_st.tail, out_st.wp, out_st.wp2,
                    out)
        nblk = len(blks)
        xr, xi, hr, hi, tl, wp, wp2, out = jax.vmap(
            one, in_axes=(0, 0, 0, 0, 0, wp_ax, wp2_ax) + (0,) * nblk)(
            st.spec_x_re, st.spec_x_im, st.spec_h_re, st.spec_h_im,
            st.tail, st.wp, st.wp2, *blks)
        return st._replace(spec_x_re=xr, spec_x_im=xi, spec_h_re=hr,
                           spec_h_im=hi, tail=tl,
                           wp=wp if wp_ax == 0 else wp[0],
                           wp2=wp2 if wp2_ax == 0 else wp2[0]), out
    return jax.lax.scan(body, state, blocks, unroll=unroll)


def pconv_stream_batched(cfg: PconvConfig, state: PconvState, blocks: Float,
                         unroll: int = 8) -> Tuple[PconvState, Float]:
    """Batched (multi-channel) LTI streaming: blocks (nblocks, B, pts),
    state fields with a leading channel axis (models.convolver.
    batched_state layout) — the vmapped per-block scan."""
    return _batched_scan(pconv_step, cfg, state,
                         (jnp.asarray(blocks, cfg._jdtype),), unroll)


def pconv_stream_batched_tv(cfg: PconvConfig, state: PconvState,
                            blocks_x: Float, blocks_h: Float,
                            unroll: int = 8) -> Tuple[PconvState, Float]:
    """Batched (multi-channel) TIME-VARYING streaming: blocks_x/blocks_h
    (nblocks, B, pts), state fields with a leading channel axis. Per-block
    semantics identical to pconv_step_tv (the serving analog of
    cl_conv.cpp:460-548's dual command queues, across many channels)."""
    return _batched_scan(pconv_step_tv, cfg, state,
                         (jnp.asarray(blocks_x, cfg._jdtype),
                          jnp.asarray(blocks_h, cfg._jdtype)), unroll)


def _offline_batched(cfg: PconvConfig, state: PconvState, blocks: Float
                     ) -> Tuple[PconvState, Float]:
    """Batched offline LTI render: blocks (nb, B, pts) -> (nb, B, pts).

    The frequency-delay-line MAC is a pure sliding-window correlation
    over the frame-spectrum timeline (the ring holds exactly the last
    nparts spectra), so the whole render is: ONE batched forward rFFT,
    the chunked gather-MAC over the timeline (ops/decomposed.py), ONE
    batched inverse, and a vectorized overlap-add — no sequential scan.
    Output matches per-block streaming within f32 reduction-order
    tolerance. State fields carry a leading channel axis (B); ring
    pointers are shared across channels (models.convolver.batched_state
    convention).
    """
    from .decomposed import _lti_mac_xla
    from .fft import exact_precision

    f32 = cfg._jdtype
    nb, B, pts = blocks.shape
    np_ = cfg.nparts
    fr, fi = _forward_partition(cfg, blocks)          # (nb, B, bins)
    fr = fr.astype(cfg._ring_jdtype).astype(f32)      # ring-dtype roundtrip
    fi = fi.astype(cfg._ring_jdtype).astype(f32)      # (== pconv_chunk)
    fr = jnp.swapaxes(fr, 0, 1)                       # (B, nb, bins)
    fi = jnp.swapaxes(fi, 0, 1)

    z = jnp.asarray(0, state.wp.dtype)
    old_r = jax.lax.dynamic_slice(
        state.spec_x_re, (z, state.wp + 1, z),
        (B, np_ - 1, cfg.bins)).astype(f32)
    old_i = jax.lax.dynamic_slice(
        state.spec_x_im, (z, state.wp + 1, z),
        (B, np_ - 1, cfg.bins)).astype(f32)

    b0 = 2.0 if cfg.bin0_mode == "exact" else 1.0
    tl_r = jnp.concatenate([old_r, fr], axis=1)       # (B, np-1+nb, bins)
    tl_i = jnp.concatenate([old_i, fi], axis=1)
    acc_r, acc_i = jax.vmap(
        lambda xr, xi, hr, hi: _lti_mac_xla(cfg, (xr, xi), (hr, hi), nb, b0))(
        tl_r, tl_i, state.spec_h_re.astype(f32), state.spec_h_im.astype(f32))

    with exact_precision():
        y = irfft_split((acc_r, acc_i), cfg.impl)     # (B, nb, 2*pts)
    tails = jnp.concatenate([state.tail[:, None], y[:, :-1, pts:]], axis=1)
    outs = jnp.swapaxes((y[:, :, :pts] + tails) / pts, 0, 1)

    # ring update: frame t lands at slot (wp + t) % np (doubled write)
    frq = fr.astype(state.spec_x_re.dtype)
    fiq = fi.astype(state.spec_x_im.dtype)
    if nb >= np_:
        s = jnp.arange(np_)
        # last frame to land in slot s: t_s = nb-1 - ((wp+nb-1-s) mod np)
        t_s = nb - 1 - ((state.wp + nb - 1 - s) % np_)
        ring_r = jnp.take(frq, t_s, axis=1)           # (B, np, bins)
        ring_i = jnp.take(fiq, t_s, axis=1)
        sxr = jnp.concatenate([ring_r, ring_r], axis=1)
        sxi = jnp.concatenate([ring_i, ring_i], axis=1)
    else:
        slots = (state.wp + jnp.arange(nb)) % np_
        sxr = state.spec_x_re.at[:, slots].set(frq)
        sxr = sxr.at[:, slots + np_].set(frq)
        sxi = state.spec_x_im.at[:, slots].set(fiq)
        sxi = sxi.at[:, slots + np_].set(fiq)
    return state._replace(
        spec_x_re=sxr, spec_x_im=sxi,
        wp=(state.wp + nb) % np_,
        tail=y[:, -1, pts:]), outs


def pconv_offline(cfg: PconvConfig, state: PconvState, blocks: Float
                  ) -> Tuple[PconvState, Float]:
    """Offline LTI render of many blocks with NO sequential dependence.

    blocks: (nblocks, pts) -> (nblocks, pts), any nblocks >= 1. Output
    equals sequential pconv_step streaming within f32 tolerance (the
    gather-MAC's reduction order differs); use pconv_stream / pconv_chunk
    when bit-equality with per-block streaming is required.
    """
    blocks = jnp.asarray(blocks, cfg._jdtype)
    bstate = state._replace(
        spec_x_re=state.spec_x_re[None], spec_x_im=state.spec_x_im[None],
        spec_h_re=state.spec_h_re[None], spec_h_im=state.spec_h_im[None],
        tail=state.tail[None])
    bstate, outs = _offline_batched(cfg, bstate, blocks[:, None])
    return state._replace(
        spec_x_re=bstate.spec_x_re[0], spec_x_im=bstate.spec_x_im[0],
        tail=bstate.tail[0], wp=bstate.wp), outs[:, 0]


def pconv_stream_batched_chunked(cfg: PconvConfig, state: PconvState,
                                 blocks: Float, K: int = 8
                                 ) -> Tuple[PconvState, Float]:
    """Latency-relaxed batched streaming: (nblocks, B, pts) processed in
    K-block chunks (K blocks of latency) through the scan-free offline
    engine — one batched forward, one gather-MAC, one batched inverse
    per chunk, so the per-channel ring window is read once per chunk
    instead of once per block.

    Outputs match per-block streaming within f32 reduction-order
    tolerance; use the per-block paths when bit-equality matters. State
    chains exactly (each chunk's final ring state is the next chunk's
    initial state). Per-channel ring-pointer vectors (the chunk engine
    assumes shared scalars) take the per-block engine.
    """
    nb, B, pts = blocks.shape
    if nb % K:
        raise ValueError(f"nblocks {nb} must be a multiple of K={K}")
    if jnp.ndim(state.wp) != 0:
        return pconv_stream_batched(cfg, state, blocks)
    chunks = jnp.asarray(blocks, cfg._jdtype).reshape(nb // K, K, B, pts)

    def body(st, ch):
        return _offline_batched(cfg, st, ch)

    state, outs = jax.lax.scan(body, state, chunks)
    return state, outs.reshape(nb, B, pts)


def pconv_stream_batched_tv_chunked(cfg: PconvConfig, state: PconvState,
                                    blocks_x: Float, blocks_h: Float,
                                    K: int = 8
                                    ) -> Tuple[PconvState, Float]:
    """Latency-relaxed batched TIME-VARYING streaming: (nblocks, B, pts)
    operand pairs processed in K-block chunks through the batched TV
    decomposed engine (ops.decomposed.stream_batched_tv_decomposed) —
    one batched forward over both operands, one TV pairing gather-MAC,
    one batched inverse per chunk.

    The TV analog of pconv_stream_batched_chunked: outputs match
    per-block streaming within f32 reduction-order tolerance; state
    chains exactly across chunks (wp/wp2 walks are the scan's).
    Per-channel ring-pointer vectors take the per-block engine.
    """
    from .decomposed import stream_batched_tv_decomposed

    nb, B, pts = blocks_x.shape
    if nb % K:
        raise ValueError(f"nblocks {nb} must be a multiple of K={K}")
    if jnp.ndim(state.wp) != 0 or jnp.ndim(state.wp2) != 0:
        return pconv_stream_batched_tv(cfg, state, blocks_x, blocks_h)
    cx = jnp.asarray(blocks_x, cfg._jdtype).reshape(nb // K, K, B, pts)
    ch = jnp.asarray(blocks_h, cfg._jdtype).reshape(nb // K, K, B, pts)

    def body(st, pair):
        return stream_batched_tv_decomposed(cfg, st, pair[0], pair[1])

    state, outs = jax.lax.scan(body, state, (cx, ch))
    return state, outs.reshape(nb, B, pts)


def convolve_oneshot(signal: Float, ir: Float, impl: str = "auto") -> Float:
    """Full linear convolution in ONE zero-padded transform (offline path).

    The streaming engine exists for bounded latency; when latency doesn't
    matter (offline rendering, IR preprocessing) a single big rFFT pair is
    the fast path — O(L log L) in two transforms.
    Matches scipy.signal.fftconvolve to f32 tolerance.

    Spectral bookkeeping in the packed convention: bin 0 carries
    (DC/2, Nyq/2) so the product needs a factor 2 there; bin M/2 is stored
    conjugated by BOTH forward transforms, and the inverse's skipped
    conjugation makes the product self-consistent (see ops/rfft.py).
    """
    from .rfft import irfft_split, rfft_split

    signal = jnp.asarray(signal, jnp.float32)
    ir = jnp.asarray(ir, jnp.float32)
    out_len = signal.shape[-1] + ir.shape[-1] - 1
    n = 4
    while n < out_len:
        n <<= 1
    m = n // 2
    xr, xi = rfft_split(jnp.pad(signal, (0, n - signal.shape[-1])), impl,
                        unnormalized=True)
    hr, hi = rfft_split(jnp.pad(ir, (0, n - ir.shape[-1])), impl,
                        unnormalized=True)
    yr = xr * hr - xi * hi
    yi = xr * hi + xi * hr
    yr = yr.at[..., 0].set(2.0 * xr[..., 0] * hr[..., 0])
    yi = yi.at[..., 0].set(2.0 * xi[..., 0] * hi[..., 0])
    y = irfft_split((yr, yi), impl, scale=1.0 / m)
    return y[..., :out_len]


def convolve(signal: Float, ir: Float, pts: int, bin0_mode: str = "exact",
             impl: str = "auto") -> Float:
    """Full linear convolution of `signal` with `ir` via the streaming engine.

    Returns len(signal) + len(ir) - 1 samples, matching
    scipy.signal.fftconvolve(signal, ir) up to f32 tolerance (with the
    default bin0_mode="exact"). IR length is zero-padded up to a multiple
    of pts. Intended for tests/benchmarks — production streaming should use
    pconv_step directly.
    """
    signal = jnp.asarray(signal, jnp.float32)
    ir = jnp.asarray(ir, jnp.float32)
    cvs = -(-ir.shape[-1] // pts) * pts
    ir_p = jnp.pad(ir, (0, cvs - ir.shape[-1]))
    cfg = PconvConfig.for_ir_length(cvs, pts, bin0_mode=bin0_mode, impl=impl)
    out_len = signal.shape[-1] + ir.shape[-1] - 1
    nblocks = -(-(signal.shape[-1] + cvs) // pts)
    sig_p = jnp.pad(signal, (0, nblocks * pts - signal.shape[-1]))
    state = push_ir(cfg, pconv_init(cfg), ir_p)
    _, out = pconv_stream(cfg, state, sig_p.reshape(nblocks, pts))
    return out.reshape(-1)[:out_len]
