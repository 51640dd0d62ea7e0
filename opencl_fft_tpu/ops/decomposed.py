"""Decomposed (batch-transform) streaming engine.

When the whole block batch is known up front (offline render, chunked
serving, the reference benchmark's 100 s renders — csound/tests.py),
the sequential per-block scan is the wrong shape: every block pays one
unbatched forward and one unbatched inverse transform, and the
scan-carried ring state keeps XLA from batching anything across blocks.

This module removes the sequential dependence — the frequency-delay-line
MAC is a pure function of the frame-spectrum TIMELINES:

  1. forward-transform ALL blocks in one batched rFFT (both operands in
     one batch for TV — the batched analog of the reference's dual
     command queues, cl_conv.cpp:460-522);
  2. run the MAC over the timelines as K-chunked XLA gathers;
  3. one batched inverse rFFT + a vectorized overlap-add;
  4. rebuild the ring state from the timeline tails (pure gathers).

Outputs match the sequential scan to f32 reduction-order tolerance
(each path sums the partition axis in a single deterministic order, but
the orders differ). Use the scan (`pconv_stream*`) when bit-equality
with per-block streaming matters.

TV pairing derivation (pinned by tests/test_decomposed.py against the
sequential scan): the reference's dual-ring walk — input ring pointer
wp increments, coefficient ring pointer wp2 decrements per block
(cl_conv.cpp:516-519) — reduces to a closed form over frame times.
Writing X_a for the input frame of block a and H_b for the coefficient
frame of block b (b < 0 meaning the pre-scan ring content):

    out[t] = sum over a in [t-nparts+1, t] of  X_a (*) H_{b(a,t)}
    b(a, t) = t - nparts + 1 + ((nparts - 1 - a) mod nparts)

i.e. the pair (a, b) always satisfies a + b == t (mod nparts) with both
frames drawn from the last nparts block times — a modular correlation
of the two frame streams.

(The closed form absorbs wp2's initial value: pconv_init sets
wp2 = nparts-1, and push-order means H frames enter at decrementing
slots; tests cover mid-stream wp2 values via state chaining.)
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .cplx import Cplx
from .rfft import irfft_split

Float = jax.Array

# Outputs per XLA MAC chunk: bounds the materialized (K, nparts, bins)
# gather windows.
_XLA_MAC_CHUNK = 8


def _h_prefix_rows(cfg, state) -> Cplx:
    """Initial-ring rows of the H timeline, time-ordered.

    Row j (j = 0..nparts-2) holds the coefficient frame with pseudo-time
    f = j - (nparts-1) < 0, which the pairing resolves to ring slot
    q = (wp2 - f) mod nparts of the pre-scan coefficient ring."""
    np_ = cfg.nparts
    f = jnp.arange(-(np_ - 1), 0)
    q = (state.wp2 - f) % np_
    return (jnp.take(state.spec_h_re, q, axis=0),
            jnp.take(state.spec_h_im, q, axis=0))


def _x_prefix_rows(cfg, state) -> Cplx:
    """Previous nparts-1 input frames, ascending time — one contiguous
    window of the doubled ring starting at wp+1 (see pconv_chunk)."""
    z = jnp.asarray(0, state.wp.dtype)
    old_r = jax.lax.dynamic_slice(
        state.spec_x_re, (state.wp + 1, z), (cfg.nparts - 1, cfg.bins))
    old_i = jax.lax.dynamic_slice(
        state.spec_x_im, (state.wp + 1, z), (cfg.nparts - 1, cfg.bins))
    return old_r, old_i


def _chunked_mac(nb: int, bins: int, chunk_fn) -> Cplx:
    """Run chunk_fn(t0) -> ((K, bins), (K, bins)) over ceil(nb/K) chunks
    as a lax.scan (compact program at any nb — an unrolled Python loop
    would emit hundreds of gather chunks at sweep sizes)."""
    k = _XLA_MAC_CHUNK
    nchunks = -(-nb // k)

    def body(_, t0):
        a_r, a_i = chunk_fn(t0)
        return None, (a_r, a_i)

    _, (accs_r, accs_i) = jax.lax.scan(
        body, None, jnp.arange(nchunks) * k)
    return (accs_r.reshape(nchunks * k, bins)[:nb],
            accs_i.reshape(nchunks * k, bins)[:nb])


def _tv_mac_xla(cfg, xtl: Cplx, htl: Cplx, nb: int, b0: float,
                wp2) -> Cplx:
    """Chunked gather evaluation of the TV pairing.

    Timeline layout (both operands): row(f) = f + nparts - 1, rows
    [0, nparts-1) the pre-scan ring content, then the fresh frames.
    The general pairing carries the coefficient-ring phase
    c = (nparts-1 - wp2) mod nparts:  b(a, t) = t - ((a + c) mod np).
    Chunks beyond nb read zero-padded timeline rows (discarded)."""
    np_, bins = cfg.nparts, cfg.bins
    k = _XLA_MAC_CHUNK
    pad = -(-nb // k) * k - nb + 1
    xr, xi = [jnp.pad(v, ((0, pad), (0, 0))) for v in xtl]
    hr, hi = [jnp.pad(v, ((0, pad), (0, 0))) for v in htl]
    p = jnp.arange(np_)
    c = (np_ - 1 - wp2) % np_

    def chunk(t0):
        t = t0 + jnp.arange(k)[:, None]                       # (K, 1)
        xrow = t + p[None, :]                                 # (K, np)
        # a = t-np+1+p;  b = t - ((a + c) mod np);  row = b + np-1
        hrow = t + np_ - 1 - (t - np_ + 1 + p[None, :] + c) % np_
        wr = jnp.take(xr, xrow, axis=0)                       # (K, np, bins)
        wi = jnp.take(xi, xrow, axis=0)
        gr = jnp.take(hr, hrow, axis=0)
        gi = jnp.take(hi, hrow, axis=0)
        a_r = jnp.sum(wr * gr - wi * gi, axis=1)              # (K, bins)
        a_i = jnp.sum(wr * gi + wi * gr, axis=1)
        a_r = a_r.at[:, 0].set(
            b0 * jnp.sum(wr[:, :, 0] * gr[:, :, 0], axis=1))
        a_i = a_i.at[:, 0].set(
            b0 * jnp.sum(wi[:, :, 0] * gi[:, :, 0], axis=1))
        return a_r, a_i

    return _chunked_mac(nb, bins, chunk)


def _lti_mac_xla(cfg, xtl: Cplx, h: Cplx, nb: int, b0: float) -> Cplx:
    """Chunked gather evaluation of the LTI sliding-window MAC
    (acc[t] = sum_q xtl[t+q] (*) h[q])."""
    np_, bins = cfg.nparts, cfg.bins
    k = _XLA_MAC_CHUNK
    pad = -(-nb // k) * k - nb + np_
    xr, xi = [jnp.pad(v, ((0, pad), (0, 0))) for v in xtl]
    hr, hi = h
    p = jnp.arange(np_)

    def chunk(t0):
        t = t0 + jnp.arange(k)[:, None]
        xrow = t + p[None, :]
        wr = jnp.take(xr, xrow, axis=0)
        wi = jnp.take(xi, xrow, axis=0)
        a_r = jnp.sum(wr * hr[None] - wi * hi[None], axis=1)
        a_i = jnp.sum(wr * hi[None] + wi * hr[None], axis=1)
        a_r = a_r.at[:, 0].set(
            b0 * jnp.sum(wr[:, :, 0] * hr[None, :, 0], axis=1))
        a_i = a_i.at[:, 0].set(
            b0 * jnp.sum(wi[:, :, 0] * hi[None, :, 0], axis=1))
        return a_r, a_i

    return _chunked_mac(nb, bins, chunk)


def stream_batched_tv_decomposed(cfg, state, blocks_x: Float,
                                 blocks_h: Float
                                 ) -> Tuple["PconvState", Float]:  # noqa: F821
    """Batched (multi-channel) TIME-VARYING decomposed streaming:
    blocks (nb, B, pts), state fields with a leading channel axis and
    SHARED scalar ring pointers (models.convolver.batched_state layout).

    The per-channel analog of stream_decomposed's TV path: one batched
    forward over all (block, operand, channel) frames, the vmapped TV
    pairing gather-MAC, one batched inverse + OLA, and per-channel ring
    rebuilds with the shared pointer walk.
    """
    from . import pconv as P
    from .fft import exact_precision

    f32 = cfg._jdtype
    np_, bins, pts = cfg.nparts, cfg.bins, cfg.pts
    blocks_x = jnp.asarray(blocks_x, f32)
    blocks_h = jnp.asarray(blocks_h, f32)
    nb, B = blocks_x.shape[0], blocks_x.shape[1]
    b0 = 2.0 if cfg.bin0_mode == "exact" else 1.0

    both = jnp.stack([blocks_x, blocks_h], axis=1)    # (nb, 2, B, pts)
    fr, fi = P._forward_partition(cfg, both)          # (nb, 2, B, bins)
    fr = fr.astype(cfg._ring_jdtype).astype(f32)
    fi = fi.astype(cfg._ring_jdtype).astype(f32)
    fxr = jnp.moveaxis(fr[:, 0], 1, 0)                # (B, nb, bins)
    fxi = jnp.moveaxis(fi[:, 0], 1, 0)
    fhr = jnp.moveaxis(fr[:, 1], 1, 0)
    fhi = jnp.moveaxis(fi[:, 1], 1, 0)

    z = jnp.asarray(0, state.wp.dtype)
    old_r = jax.lax.dynamic_slice(
        state.spec_x_re, (z, state.wp + 1, z),
        (B, np_ - 1, bins)).astype(f32)
    old_i = jax.lax.dynamic_slice(
        state.spec_x_im, (z, state.wp + 1, z),
        (B, np_ - 1, bins)).astype(f32)
    xtl_r = jnp.concatenate([old_r, fxr], axis=1)     # (B, np-1+nb, bins)
    xtl_i = jnp.concatenate([old_i, fxi], axis=1)

    f = jnp.arange(-(np_ - 1), 0)
    q = (state.wp2 - f) % np_
    h0_r = jnp.take(state.spec_h_re, q, axis=1).astype(f32)
    h0_i = jnp.take(state.spec_h_im, q, axis=1).astype(f32)
    htl_r = jnp.concatenate([h0_r, fhr], axis=1)
    htl_i = jnp.concatenate([h0_i, fhi], axis=1)

    acc_r, acc_i = jax.vmap(
        lambda a, b_, g, h_: _tv_mac_xla(
            cfg, (a, b_), (g, h_), nb, b0, state.wp2))(
        xtl_r, xtl_i, htl_r, htl_i)

    with exact_precision():
        y = irfft_split((acc_r, acc_i), cfg.impl)     # (B, nb, 2*pts)
    tails = jnp.concatenate([state.tail[:, None], y[:, :-1, pts:]], axis=1)
    outs = jnp.swapaxes((y[:, :, :pts] + tails) / pts, 0, 1)

    # per-channel ring rebuilds, shared pointer walk
    rdt = state.spec_x_re.dtype
    s = jnp.arange(np_)
    if nb >= np_:
        t_s = nb - 1 - ((state.wp + nb - 1 - s) % np_)
        ring_r = jnp.take(fxr, t_s, axis=1).astype(rdt)
        ring_i = jnp.take(fxi, t_s, axis=1).astype(rdt)
        sxr = jnp.concatenate([ring_r, ring_r], axis=1)
        sxi = jnp.concatenate([ring_i, ring_i], axis=1)
    else:
        slots = (state.wp + jnp.arange(nb)) % np_
        sxr = state.spec_x_re.at[:, slots].set(fxr.astype(rdt))
        sxr = sxr.at[:, slots + np_].set(fxr.astype(rdt))
        sxi = state.spec_x_im.at[:, slots].set(fxi.astype(rdt))
        sxi = sxi.at[:, slots + np_].set(fxi.astype(rdt))
    t_q = nb - 1 - ((nb - 1 - state.wp2 + s) % np_)
    hdt = state.spec_h_re.dtype
    return state._replace(
        spec_x_re=sxr, spec_x_im=sxi,
        spec_h_re=jnp.take(htl_r, t_q + np_ - 1, axis=1).astype(hdt),
        spec_h_im=jnp.take(htl_i, t_q + np_ - 1, axis=1).astype(hdt),
        tail=y[:, -1, pts:],
        wp=(state.wp + nb) % np_,
        wp2=(state.wp2 - nb) % np_), outs


def stream_decomposed(cfg, state, blocks_x: Float,
                      blocks_h: Optional[Float] = None
                      ) -> Tuple["PconvState", Float]:  # noqa: F821
    """Process nb blocks with NO sequential dependence (LTI when
    blocks_h is None, time-varying otherwise).

    Drop-in for pconv_stream / pconv_stream_tv: same state in/out
    contract (chaining calls matches one big call), outputs equal the
    sequential scan within f32 reduction-order tolerance.
    """
    from . import pconv as P
    from .fft import exact_precision

    f32 = cfg._jdtype
    np_, bins, pts = cfg.nparts, cfg.bins, cfg.pts
    blocks_x = jnp.asarray(blocks_x, f32)
    nb = blocks_x.shape[0]
    tv = blocks_h is not None
    b0 = 2.0 if cfg.bin0_mode == "exact" else 1.0

    # 1. batched forward transforms (both operands in one batch for TV)
    if tv:
        blocks_h = jnp.asarray(blocks_h, f32)
        both = jnp.stack([blocks_x, blocks_h], axis=1)    # (nb, 2, pts)
        fr, fi = P._forward_partition(cfg, both)
        fr = fr.astype(cfg._ring_jdtype).astype(f32)      # ring roundtrip
        fi = fi.astype(cfg._ring_jdtype).astype(f32)      # (== pconv_chunk)
        fxr, fxi = fr[:, 0], fi[:, 0]
        fhr, fhi = fr[:, 1], fi[:, 1]
    else:
        fxr, fxi = P._forward_partition(cfg, blocks_x)
        fxr = fxr.astype(cfg._ring_jdtype).astype(f32)
        fxi = fxi.astype(cfg._ring_jdtype).astype(f32)
        fhr = fhi = None

    # 2. timelines + MAC
    old_r, old_i = _x_prefix_rows(cfg, state)
    xtl_r = jnp.concatenate([old_r.astype(f32), fxr], axis=0)
    xtl_i = jnp.concatenate([old_i.astype(f32), fxi], axis=0)
    if tv:
        h0_r, h0_i = _h_prefix_rows(cfg, state)
        htl_r = jnp.concatenate([h0_r.astype(f32), fhr], axis=0)
        htl_i = jnp.concatenate([h0_i.astype(f32), fhi], axis=0)
        acc_r, acc_i = _tv_mac_xla(
            cfg, (xtl_r, xtl_i), (htl_r, htl_i), nb, b0, state.wp2)
    else:
        h = (state.spec_h_re.astype(f32), state.spec_h_im.astype(f32))
        acc_r, acc_i = _lti_mac_xla(cfg, (xtl_r, xtl_i), h, nb, b0)
    acc_r, acc_i = acc_r[:nb], acc_i[:nb]

    # 3. batched inverse + vectorized overlap-add
    with exact_precision():
        y = irfft_split((acc_r, acc_i), cfg.impl)         # (nb, 2*pts)
    tails = jnp.concatenate([state.tail[None], y[:-1, pts:]], axis=0)
    outs = (y[:, :pts] + tails) / pts

    # 4. ring-state reconstruction from the timelines
    rdt = state.spec_x_re.dtype
    s = jnp.arange(np_)
    if nb >= np_:
        # last frame to land in slot s: t_s = nb-1 - ((wp+nb-1-s) mod np)
        t_s = nb - 1 - ((state.wp + nb - 1 - s) % np_)
        ring_r = jnp.take(fxr, t_s, axis=0).astype(rdt)
        ring_i = jnp.take(fxi, t_s, axis=0).astype(rdt)
        sxr = jnp.concatenate([ring_r, ring_r], axis=0)
        sxi = jnp.concatenate([ring_i, ring_i], axis=0)
    else:
        slots = (state.wp + jnp.arange(nb)) % np_
        frq = fxr.astype(rdt)
        fiq = fxi.astype(rdt)
        sxr = state.spec_x_re.at[slots].set(frq).at[slots + np_].set(frq)
        sxi = state.spec_x_im.at[slots].set(fiq).at[slots + np_].set(fiq)
    state = state._replace(
        spec_x_re=sxr, spec_x_im=sxi,
        wp=(state.wp + nb) % np_, tail=y[-1, pts:])
    if tv:
        # slot q's final content: the latest h frame written at or
        # before nb-1 whose slot is q — timeline row t' + np - 1 with
        # t' = nb-1 - ((nb-1-wp2+q) mod np) (t' < 0 resolves to the
        # time-ordered initial-ring prefix rows, same formula)
        t_q = nb - 1 - ((nb - 1 - state.wp2 + s) % np_)
        hdt = state.spec_h_re.dtype
        state = state._replace(
            spec_h_re=jnp.take(htl_r, t_q + np_ - 1, axis=0).astype(hdt),
            spec_h_im=jnp.take(htl_i, t_q + np_ - 1, axis=0).astype(hdt),
            wp2=(state.wp2 - nb) % np_)
    return state, outs
