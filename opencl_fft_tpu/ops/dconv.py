"""Direct time-domain FIR convolution with a delay line.

Capability parity with ``Cldconv`` (``cl_dconv.h:17-66``, ``cl_dconv.cpp``):
a circular delay line of ``irsize + vsize`` samples; each block of ``vsize``
input samples is written at the ring pointer, then every output sample is
the dot product of the IR against the delay line read oldest -> newest with
reversed coefficients (``cl_dconv.cpp:32-43``). A time-varying variant
streams the second operand into the coefficient buffer with the same ring
arithmetic (``cl_dconv.cpp:134-148``).

Redesign: the per-(tap x sample) thread grid with CAS-loop float atomics
(``cl_dconv.cpp:17-31,42``) becomes a single VALID cross-correlation (a
sliding-window matvec) over a rotated view of the ring — deterministic,
one fused XLA program per block. The wrap-around write keeps the reference's ring arithmetic
(including writes that straddle the end), but uses correct byte counts —
the reference's short-read-after-wrap artifact (``cl_dconv.cpp:112-130``,
SURVEY §8 Q3) is NOT reproduced.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

Float = jax.Array


@dataclasses.dataclass(frozen=True)
class DconvConfig:
    """Static configuration (ctor args of Cldconv, cl_dconv.cpp:46-51).

    delay_compat: the reference kernel reads del[(wp+n+h) % end] with
    h <= irsize-1 after wp has advanced past the new block
    (cl_dconv.cpp:41,124-125), so output sample n never sees its own-time
    input — the result is sum_k coefs[k] * x[n-1-k], one sample later than
    a standard FIR. Default False computes the standard alignment
    (== np.convolve); True reproduces the reference's extra sample of delay.
    """

    irsize: int
    vsize: int
    delay_compat: bool = False
    dtype: str = "f32"   # "f32" | "f64" (USE_DOUBLE parity; needs x64)

    def __post_init__(self):
        if self.irsize < 1 or self.vsize < 1:
            raise ValueError("irsize and vsize must be positive")
        if self.dtype not in ("f32", "f64"):
            raise ValueError(f"dtype must be 'f32'|'f64', got {self.dtype}")

    @property
    def _jdtype(self):
        import jax.numpy as _jnp
        return _jnp.float64 if self.dtype == "f64" else _jnp.float32

    @property
    def ring(self) -> int:
        return self.irsize + self.vsize


class DconvState(NamedTuple):
    """Device-resident ring state (cl_dconv.h:18-19 as a pytree).

    ``coefs`` has ring length like the reference's coefficient buffer
    (cl_dconv.cpp:90-91) so the time-varying write pattern is identical;
    the LTI path only ever reads the first irsize entries.
    """

    delay: Float   # (irsize + vsize,)
    coefs: Float   # (irsize + vsize,)
    wp: Float      # () int32


def dconv_init(cfg: DconvConfig) -> DconvState:
    return DconvState(
        delay=jnp.zeros((cfg.ring,), cfg._jdtype),
        coefs=jnp.zeros((cfg.ring,), cfg._jdtype),
        wp=jnp.asarray(0, jnp.int32),
    )


def push_ir(cfg: DconvConfig, state: DconvState, ir: Float) -> DconvState:
    """Load coefficients (Cldconv::push_ir, cl_dconv.cpp:150-153)."""
    ir = jnp.asarray(ir, cfg._jdtype)
    if ir.shape != (cfg.irsize,):
        raise ValueError(f"IR must have shape ({cfg.irsize},), got {ir.shape}")
    return state._replace(coefs=state.coefs.at[: cfg.irsize].set(ir))


def _sliding_windows(d: Float, rows: int, width: int) -> Float:
    """W[i, :] = d[i : i+width] for i in [0, rows), via tile/reshape.

    With r = [d, 0] of length L+1, flattening rows of length L+2 over a
    tiling of r advances the phase by exactly one sample per row
    (i*(L+2) mod (L+1) == i), so row i reads d shifted left by i. Requires
    rows - 1 + width <= L + 1, which the delay-line geometry guarantees
    (rows-1 + width = vsize + irsize = L).
    """
    L = d.shape[-1]
    r = jnp.concatenate([d, jnp.zeros((1,), d.dtype)])
    reps = (rows * (L + 2) + L) // (L + 1)
    t = jnp.tile(r, reps)[: rows * (L + 2)].reshape(rows, L + 2)
    return t[:, :width]


def _ring_write(ring: Float, block: Float, wp: Float) -> Float:
    """Write `block` at ring position wp with wrap-around.

    Rotate so wp lands at 0, write contiguously, rotate back — one fused
    gather/scatter pair under XLA, replacing the two-segment
    clEnqueueWriteBuffer dance of cl_dconv.cpp:112-122.
    """
    n = block.shape[-1]
    r = jnp.roll(ring, -wp)
    r = r.at[:n].set(block)
    return jnp.roll(r, wp)


def dconv_step(cfg: DconvConfig, state: DconvState, block: Float
               ) -> Tuple[DconvState, Float]:
    """One LTI block: Cldconv::convolution(out, in) parity
    (cl_dconv.cpp:109-132). block: (vsize,) -> out: (vsize,).

    Kernel math (cl_dconv.cpp:37-42): out[n] = sum_h del[(wp+n+h) % end] *
    coefs[irsize-1-h], wp already advanced past the new block — i.e. the
    delay line read oldest -> newest against time-reversed coefficients.
    """
    block = jnp.asarray(block, cfg._jdtype)
    delay = _ring_write(state.delay, block, state.wp)
    wp = (state.wp + cfg.vsize) % cfg.ring            # cl_dconv.cpp:124
    # Rotated view d[j] = delay[(wp + j) % end]; then
    # out[n] = sum_h d[n + h] * k[h] with k[h] = coefs[irsize-1-h]:
    # a VALID cross-correlation.
    d = jnp.roll(delay, -wp)
    k = jnp.flip(state.coefs[: cfg.irsize])
    # Toeplitz-windows formulation: sliding windows of the delay line feed
    # one matvec, built with a tile/reshape trick (no gather). HIGHEST
    # keeps the f32 product out of TF32 on GPUs that have it.
    valid = jnp.dot(_sliding_windows(d, cfg.vsize + 1, cfg.irsize), k,
                    precision=jax.lax.Precision.HIGHEST)         # (vsize+1,)
    # valid[n] = sum_h d[n+h] k[h]; the reference alignment is valid[:vsize]
    # (one sample late, see DconvConfig.delay_compat); standard FIR is the
    # window shifted by one so out[n] includes x[n]*coefs[0].
    off = 0 if cfg.delay_compat else 1
    out = jax.lax.dynamic_slice(valid, (off,), (cfg.vsize,))
    return state._replace(delay=delay, wp=wp), out


def dconv_step_tv(cfg: DconvConfig, state: DconvState, block_x: Float,
                  block_h: Float) -> Tuple[DconvState, Float]:
    """One time-varying block: Cldconv::convolution(out, in1, in2) parity
    (cl_dconv.cpp:134-148): the second operand streams into the coefficient
    ring at the same pointer/wrap positions as the delay line, then the LTI
    path runs."""
    coefs = _ring_write(state.coefs, jnp.asarray(block_h, cfg._jdtype), state.wp)
    return dconv_step(cfg, state._replace(coefs=coefs), block_x)


def dconv_stream(cfg: DconvConfig, state: DconvState, blocks: Float,
                 unroll: int = 8) -> Tuple[DconvState, Float]:
    """Run many LTI blocks through a lax.scan. blocks: (nblocks, vsize).
    ``unroll`` amortizes the per-iteration loop overhead."""
    def body(st, blk):
        return dconv_step(cfg, st, blk)
    return jax.lax.scan(body, state, blocks, unroll=unroll)


def convolve_direct(signal: Float, ir: Float, vsize: int = 64) -> Float:
    """Full linear convolution via the streaming direct engine (test helper).

    Returns len(signal) + len(ir) - 1 samples matching np.convolve.
    """
    signal = jnp.asarray(signal, jnp.float32)
    ir = jnp.asarray(ir, jnp.float32)
    cfg = DconvConfig(irsize=ir.shape[-1], vsize=vsize)
    out_len = signal.shape[-1] + ir.shape[-1] - 1
    nblocks = -(-out_len // vsize)
    sig_p = jnp.pad(signal, (0, nblocks * vsize - signal.shape[-1]))
    state = push_ir(cfg, dconv_init(cfg), ir)
    _, out = dconv_stream(cfg, state, sig_p.reshape(nblocks, vsize))
    return out.reshape(-1)[:out_len]
