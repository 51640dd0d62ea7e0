"""Flagship model: batched streaming convolution engines.

The reference's "models" are its audio processors — LTI convolution reverb
(`clconv`) and time-varying convolution (`cltvconv`). This module packages
them as batched, jit-first engines processing many channels at once — the
deployment shape for accelerator serving (a single channel underutilizes
the device; batch is the free axis).

``TVConvolver`` is the flagship: per block it runs a batched dual forward
real FFT, the frequency-delay-line MAC, inverse FFT and overlap-add — every
compute primitive of the framework in one step. Its single-chip step is the
graft entry point; its (dp, tp)-sharded variant (parallel/sharded.py) is the
multi-chip path.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops import pconv as _p
from ..ops.cplx import Cplx
from ..ops.fft import fft_split

Float = jax.Array


def batched_state(cfg: _p.PconvConfig, batch: int) -> _p.PconvState:
    """Vmapped-engine state: every field gains a leading batch axis except
    the ring pointers, which are shared across channels (all channels
    advance in lockstep)."""
    def z(rows):
        # ring planes honor cfg.ring_dtype (tail stays f32), matching
        # pconv_init — a bf16 config must actually get bf16 rings here
        return jnp.zeros((batch, rows, cfg.bins), cfg._ring_jdtype)

    return _p.PconvState(
        spec_x_re=z(2 * cfg.nparts), spec_x_im=z(2 * cfg.nparts),
        spec_h_re=z(cfg.nparts), spec_h_im=z(cfg.nparts),
        tail=jnp.zeros((batch, cfg.pts), jnp.float32),
        wp=jnp.asarray(0, jnp.int32),
        wp2=jnp.asarray(cfg.nparts - 1, jnp.int32),
    )


def _vmapped(fn, cfg):
    """vmap a pconv step over the batch axis with shared ring pointers."""
    in_axes = (_p.PconvState(
        spec_x_re=0, spec_x_im=0, spec_h_re=0, spec_h_im=0,
        tail=0, wp=None, wp2=None),)
    out_state_axes = _p.PconvState(
        spec_x_re=0, spec_x_im=0, spec_h_re=0, spec_h_im=0,
        tail=0, wp=None, wp2=None)

    def wrapped(state, *blocks):
        return jax.vmap(
            lambda st, *b: fn(cfg, st, *b),
            in_axes=in_axes + (0,) * len(blocks),
            out_axes=(out_state_axes, 0),
        )(state, *blocks)

    return wrapped


class Convolver:
    """Batched LTI convolution engine (the `clconv` model).

    batch channels, each convolving against its own IR of cfg.cvs samples.
    """

    def __init__(self, cfg: _p.PconvConfig, batch: int):
        self.cfg = cfg
        self.batch = batch
        self.state = batched_state(cfg, batch)
        self._xf = None            # in-progress crossfaded IR swap
        self._xf_fns = None        # lazily-jitted (begin, step, push_masked)
        self._step = jax.jit(_vmapped(_p.pconv_step, cfg), donate_argnums=(0,))
        self._push = jax.jit(_vmapped_push(cfg), donate_argnums=(0,))
        # jitted entry points are built ONCE — a fresh jax.jit wrapper per
        # call would re-trace/re-lower the whole scan program every time
        self._stream = jax.jit(
            functools.partial(_p.pconv_stream_batched, cfg),
            static_argnames=("unroll",), donate_argnums=(0,))
        chunk_step = _vmapped(_p.pconv_chunk, cfg)

        @functools.partial(jax.jit, static_argnums=2, donate_argnums=0)
        def _stream_chunked(state, chunks, unroll):
            return jax.lax.scan(lambda s, c: chunk_step(s, c), state,
                                chunks, unroll=unroll)

        self._stream_chunked = _stream_chunked
        self._render = jax.jit(
            functools.partial(_p._offline_batched, cfg), donate_argnums=(0,))

    def push_ir(self, irs: Float) -> None:
        """irs: (batch, cvs)."""
        self._collapse_fade()
        self.state = self._push(self.state, jnp.asarray(irs, jnp.float32))

    def _collapse_fade(self) -> None:
        if getattr(self, "_xf", None) is not None:
            self.state = self._xf.state
            self._xf = None

    def set_ir(self, irs: Float, channels=None, fade_blocks: int = 8) -> None:
        """Replace per-channel IRs on the live batched stream (the serving
        hot-swap): each swapped channel crossfades between its two exact
        convolutions over the next ``fade_blocks`` step() calls while
        untouched channels are bit-exactly unaffected (their old/new
        coefficient rings are identical, so the blend is a no-op).

        irs: (k, cvs) with ``channels`` a length-k index list, or
        (batch, cvs) with ``channels=None`` to swap every channel.
        ``fade_blocks=0`` swaps instantly (reference push_ir semantics,
        cl_conv.cpp:353-388 — a click on a live stream). A second call
        mid-fade adopts the in-flight targets and fades to the new ones.
        """
        import numpy as np

        irs = jnp.asarray(irs, jnp.float32)
        if irs.ndim != 2 or irs.shape[1] != self.cfg.cvs:
            raise ValueError(
                f"irs must be (k, {self.cfg.cvs}), got {irs.shape}")
        if channels is None:
            if irs.shape[0] != self.batch:
                raise ValueError(
                    f"channels=None needs (batch={self.batch}, cvs) irs, "
                    f"got {irs.shape}")
            full, mask = irs, jnp.ones((self.batch,), bool)
        else:
            idx = np.asarray(channels, np.int32).reshape(-1)
            if idx.size != irs.shape[0]:
                raise ValueError(
                    f"{idx.size} channel indices for {irs.shape[0]} IRs")
            if idx.size != np.unique(idx).size:
                raise ValueError("duplicate channel indices")
            if idx.size and (idx.min() < 0 or idx.max() >= self.batch):
                raise ValueError(
                    f"channel indices out of range [0, {self.batch})")
            full = jnp.zeros((self.batch, self.cfg.cvs), jnp.float32
                             ).at[idx].set(irs)
            mask = jnp.zeros((self.batch,), bool).at[idx].set(True)
        if fade_blocks < 0:
            raise ValueError(f"fade_blocks must be >= 0, got {fade_blocks}")
        self._collapse_fade()
        if self._xf_fns is None:
            begin, step, push_masked = _vmapped_xfade(self.cfg)
            self._xf_fns = (jax.jit(begin), jax.jit(step, donate_argnums=(0,)),
                            jax.jit(push_masked, donate_argnums=(0,)))
        if fade_blocks == 0:
            self.state = self._xf_fns[2](self.state, full, mask)
            return
        self._xf = self._xf_fns[0](self.state, full, mask)
        self._fade_pos, self._fade_total = 0, int(fade_blocks)

    def step(self, blocks: Float) -> Float:
        """blocks: (batch, pts) -> (batch, pts)."""
        if getattr(self, "_xf", None) is not None:
            import numpy as np
            pts = self.cfg.pts
            ramp = (np.arange(pts, dtype=np.float32) + 1
                    + self._fade_pos * pts) / np.float32(self._fade_total * pts)
            self._xf, out = self._xf_fns[1](self._xf, blocks, ramp)
            self._fade_pos += 1
            if self._fade_pos >= self._fade_total:
                self._collapse_fade()
            return out
        self.state, out = self._step(self.state, blocks)
        return out

    def stream(self, blocks: Float, unroll: int = 8, chunk: int = 1) -> Float:
        """Offline rendering: scan over (nblocks, batch, pts) on device.

        chunk > 1 groups that many blocks per fused pconv_chunk call
        (equal to per-block streaming to f32 rounding — see
        ops.pconv.pconv_chunk; requires nblocks % chunk == 0
        and chunk <= nparts)."""
        if self._xf is not None:
            raise RuntimeError(
                "an IR crossfade is in progress — drive step() for the "
                "remaining fade blocks before bulk streaming")
        blocks = jnp.asarray(blocks, jnp.float32)
        if chunk > 1:
            n, b, pts = blocks.shape
            if n % chunk:
                raise ValueError(f"nblocks {n} must be a multiple of chunk {chunk}")
            # per-channel chunk arg is (chunk, pts): move batch to front
            chunks = blocks.reshape(n // chunk, chunk, b, pts).swapaxes(1, 2)
            self.state, out = self._stream_chunked(
                self.state, chunks, max(1, unroll // chunk))
            out = out.swapaxes(1, 2).reshape(n, b, pts)
            return out

        self.state, out = self._stream(self.state, blocks, unroll=unroll)
        return out

    def render(self, blocks: Float) -> Float:
        """Offline batched render: (nblocks, batch, pts) -> same shape.

        The MAC is a pure sliding-window correlation over the
        precomputed frame spectra, so the whole render is batched
        transforms + one chunked gather-MAC — no sequential scan
        (ops/pconv._offline_batched). Output matches stream() within f32
        tolerance; latency is the full render length (use step()/stream()
        for bounded latency)."""
        if self._xf is not None:
            raise RuntimeError(
                "an IR crossfade is in progress — drive step() for the "
                "remaining fade blocks before bulk rendering")
        blocks = jnp.asarray(blocks, jnp.float32)
        self.state, out = self._render(self.state, blocks)
        return out


def _vmapped_push(cfg):
    def wrapped(state, irs):
        return jax.vmap(
            lambda st, ir: _p.push_ir(cfg, st, ir),
            in_axes=(_p.PconvState(
                spec_x_re=0, spec_x_im=0, spec_h_re=0, spec_h_im=0,
                tail=0, wp=None, wp2=None), 0),
            out_axes=_p.PconvState(
                spec_x_re=0, spec_x_im=0, spec_h_re=0, spec_h_im=0,
                tail=0, wp=None, wp2=None),
        )(state, irs)
    return wrapped


_STATE_AXES = _p.PconvState(spec_x_re=0, spec_x_im=0, spec_h_re=0,
                            spec_h_im=0, tail=0, wp=None, wp2=None)
_XF_AXES = _p.XfadeState(state=_STATE_AXES, old_h_re=0, old_h_im=0,
                         old_tail=0)


def _vmapped_xfade(cfg):
    """Batched crossfaded IR replacement (ops/pconv.pconv_*_xfade).

    ``begin(state, irs, mask)`` starts a fade only for channels where
    ``mask`` is True: masked-out channels keep their current coefficient
    ring and tail on BOTH paths, so the per-sample blend is exactly a
    no-op for them (old == new bitwise) while swapped channels fade
    between their two exact convolutions. ``step`` shares one ramp across
    the batch (all channels of a set_ir call fade on the same schedule).
    """

    def begin(state, irs, mask):
        xf = jax.vmap(lambda st, ir: _p.pconv_begin_xfade(cfg, st, ir),
                      in_axes=(_STATE_AXES, 0), out_axes=_XF_AXES)(state, irs)
        m2, m3 = mask[:, None], mask[:, None, None]
        st = state._replace(
            spec_h_re=jnp.where(m3, xf.state.spec_h_re, state.spec_h_re),
            spec_h_im=jnp.where(m3, xf.state.spec_h_im, state.spec_h_im),
            tail=jnp.where(m2, xf.state.tail, state.tail))
        return _p.XfadeState(state=st, old_h_re=state.spec_h_re,
                             old_h_im=state.spec_h_im, old_tail=state.tail)

    def step(xf, blocks, ramp):
        return jax.vmap(lambda f, b: _p.pconv_step_xfade(cfg, f, b, ramp),
                        in_axes=(_XF_AXES, 0),
                        out_axes=(_XF_AXES, 0))(xf, blocks)

    def push_masked(state, irs, mask):
        new = _vmapped_push(cfg)(state, irs)
        m3 = mask[:, None, None]
        return state._replace(
            spec_h_re=jnp.where(m3, new.spec_h_re, state.spec_h_re),
            spec_h_im=jnp.where(m3, new.spec_h_im, state.spec_h_im))

    return begin, step, push_masked


class TVConvolver:
    """Flagship: batched time-varying convolution engine (`cltvconv` model).

    Both operands stream per channel; each block exercises batched forward
    rFFTs (leading dim 2*batch), the partition MAC and inverse/OLA.
    """

    def __init__(self, cfg: _p.PconvConfig, batch: int):
        self.cfg = cfg
        self.batch = batch
        self.state = batched_state(cfg, batch)
        self._step = jax.jit(_vmapped(_p.pconv_step_tv, cfg), donate_argnums=(0,))
        # built once — see Convolver.__init__ on the per-call re-trace cost
        self._stream = jax.jit(
            functools.partial(_p.pconv_stream_batched_tv, cfg),
            static_argnames=("unroll",), donate_argnums=(0,))
        self._stream_chunked_fns = {}    # K -> jitted chunked engine

    def step(self, blocks_x: Float, blocks_h: Float) -> Float:
        """(batch, pts) x 2 -> (batch, pts)."""
        self.state, out = self._step(self.state, blocks_x, blocks_h)
        return out

    def stream(self, blocks_x: Float, blocks_h: Float, unroll: int = 8) -> Float:
        """Offline rendering over (nblocks, batch, pts) pairs (the vmapped
        per-block TV scan)."""
        self.state, out = self._stream(self.state,
                                       jnp.asarray(blocks_x, jnp.float32),
                                       jnp.asarray(blocks_h, jnp.float32),
                                       unroll=unroll)
        return out

    def stream_chunked(self, blocks_x: Float, blocks_h: Float,
                       K: int = 8) -> Float:
        """Latency-relaxed TV serving: (nblocks, batch, pts) pairs in
        K-block chunks through pconv_stream_batched_tv_chunked (the
        batched TV decomposed engine). Within f32 reduction-order
        tolerance of stream(); state chains exactly."""
        fn = self._stream_chunked_fns.get(K)
        if fn is None:
            fn = jax.jit(functools.partial(
                _p.pconv_stream_batched_tv_chunked, self.cfg, K=K),
                donate_argnums=(0,))
            self._stream_chunked_fns[K] = fn
        self.state, out = fn(self.state,
                             jnp.asarray(blocks_x, jnp.float32),
                             jnp.asarray(blocks_h, jnp.float32))
        return out

    def step_fn(self):
        """The raw jittable (state, bx, bh) -> (state, out) function —
        the graft entry surface."""
        return _vmapped(_p.pconv_step_tv, self.cfg)


class MatrixConvolver:
    """True-stereo / matrix convolution: ``out[o] = sum_i in[i] * ir[o, i]``.

    The standard convolution-reverb topology beyond per-channel
    processing — e.g. true stereo is the (2 in -> 2 out) case with four
    IRs (LL, LR, RL, RR). The reference has no counterpart: it would
    take n_in*n_out `clconv` opcode instances plus manual mixing
    (csound/opcode.cpp:157-253 is strictly 1-in 1-out).

    Built on the batched ``Convolver`` with one channel per (out, in)
    IR pair: the input block is tiled across the n_out axis, and outputs
    reduce over n_in — both free reshapes around the batched engine, so
    the whole matrix runs as ONE device step. IR hot-swap works per
    matrix entry through ``set_ir(irs, entries=[(o, i), ...])``.
    """

    def __init__(self, cfg: _p.PconvConfig, n_in: int, n_out: int):
        if n_in < 1 or n_out < 1:
            raise ValueError(f"need n_in, n_out >= 1, got {n_in}, {n_out}")
        self.cfg = cfg
        self.n_in = n_in
        self.n_out = n_out
        self._conv = Convolver(cfg, n_out * n_in)

    def push_ir(self, irs: Float) -> None:
        """irs: (n_out, n_in, cvs)."""
        irs = jnp.asarray(irs, jnp.float32)
        if irs.shape != (self.n_out, self.n_in, self.cfg.cvs):
            raise ValueError(
                f"irs must be ({self.n_out}, {self.n_in}, {self.cfg.cvs}), "
                f"got {irs.shape}")
        self._conv.push_ir(irs.reshape(self.n_out * self.n_in, self.cfg.cvs))

    def set_ir(self, irs: Float, entries=None, fade_blocks: int = 8) -> None:
        """Hot-swap matrix entries on the live stream.

        irs: (k, cvs) with ``entries`` a list of k (out, in) pairs, or
        (n_out, n_in, cvs) with ``entries=None`` for the whole matrix.
        Crossfaded exactly like ``Convolver.set_ir`` (untouched entries
        bit-exact)."""
        if entries is None:
            irs = jnp.asarray(irs, jnp.float32)
            if irs.shape != (self.n_out, self.n_in, self.cfg.cvs):
                raise ValueError(
                    f"irs must be ({self.n_out}, {self.n_in}, "
                    f"{self.cfg.cvs}), got {irs.shape}")
            self._conv.set_ir(
                irs.reshape(self.n_out * self.n_in, self.cfg.cvs),
                fade_blocks=fade_blocks)
            return
        channels = [o * self.n_in + i for (o, i) in entries]
        for (o, i) in entries:
            if not (0 <= o < self.n_out and 0 <= i < self.n_in):
                raise ValueError(f"entry ({o}, {i}) out of range "
                                 f"({self.n_out} x {self.n_in})")
        self._conv.set_ir(irs, channels=channels, fade_blocks=fade_blocks)

    def step(self, blocks: Float) -> Float:
        """blocks: (n_in, pts) -> (n_out, pts)."""
        blocks = jnp.asarray(blocks, jnp.float32)
        if blocks.shape != (self.n_in, self.cfg.pts):
            raise ValueError(
                f"blocks must be ({self.n_in}, {self.cfg.pts}), "
                f"got {blocks.shape}")
        tiled = jnp.tile(blocks, (self.n_out, 1))          # (n_out*n_in, pts)
        out = self._conv.step(tiled)
        return out.reshape(self.n_out, self.n_in, self.cfg.pts).sum(axis=1)

    def stream(self, blocks: Float, unroll: int = 8) -> Float:
        """Offline rendering: (nblocks, n_in, pts) -> (nblocks, n_out, pts)."""
        blocks = jnp.asarray(blocks, jnp.float32)
        n = blocks.shape[0]
        tiled = jnp.tile(blocks, (1, self.n_out, 1))
        out = self._conv.stream(tiled, unroll=unroll)
        return out.reshape(n, self.n_out, self.n_in, self.cfg.pts).sum(axis=2)


class BatchedFFT:
    """Batched transform model (the `clfft`/`clrfft` opcodes at scale):
    many independent N-point transforms in one device program."""

    def __init__(self, n: int, forward: bool = True, impl: str = "auto"):
        self.n = n
        self.sign = -1 if forward else +1
        self.impl = impl
        self._fn = jax.jit(functools.partial(fft_split, sign=self.sign, impl=impl))

    def __call__(self, x: Cplx) -> Cplx:
        return self._fn(x)
