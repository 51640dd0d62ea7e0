"""Sharded execution of the FFT and partitioned-convolution engines.

Replacement for the reference's (absent) scale-out story
(SURVEY §2: the only parallelism is intra-device work-items + two command
queues). Two axes of scale:

  * ``sharded_fft`` — batch axis sharded over the whole mesh; each device
    transforms its shard locally, zero communication. This is the scale-out
    path for the batched-FFT benchmark.

  * ``ShardedPconv`` — batched partitioned convolution on a (dp, tp) mesh:
    channels shard over ``dp``; the frequency-delay line (partition axis)
    shards over ``tp``. Design: the input spectral ring is REPLICATED
    across tp (it changes by one frame per block — cheap), the coefficient
    ring and the partition-MAC are SHARDED, and one ``psum(bins)`` across devices
    completes the spectral accumulation. Per-block communication is
    O(pts) floats — independent of IR length, so arbitrarily long IRs
    scale across chips.

Everything is expressed with ``shard_map`` over a ``jax.sharding.Mesh`` and
XLA collectives; no explicit queues/transfers (SURVEY §5.8 mapping).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import pconv as _p
from ..ops.cplx import Cplx
from ..ops.fft import fft_split
from ..ops.rfft import irfft_split, rfft_split

Float = jax.Array


# ---------------------------------------------------------------------------
# Batch-sharded FFT
# ---------------------------------------------------------------------------

def sharded_fft(x: Cplx, mesh: Mesh, sign: int = -1, impl: str = "auto",
                axis: str = "dp") -> Cplx:
    """Batched FFT with the leading axis sharded over `axis`.

    x: split (batch, n) pair. Pure data parallelism: no collectives.
    """
    spec = P(axis, None)

    @functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)
    )
    def run(re, im):
        return fft_split((re, im), sign, impl)

    return run(x[0], x[1])


# ---------------------------------------------------------------------------
# dp x tp sharded partitioned convolution
# ---------------------------------------------------------------------------

def sharded_pconv_init(cfg: _p.PconvConfig, batch: int):
    """State for a batched sharded convolver.

    spec_x: (batch, nparts, bins) — replicated over tp, sharded over dp
    spec_h: (batch, nparts, bins) — sharded over (dp, tp)
    tail:   (batch, pts); wp/wp2 scalars (replicated)
    """
    def z():
        return jnp.zeros((batch, cfg.nparts, cfg.bins), jnp.float32)

    return dict(
        spec_x_re=z(), spec_x_im=z(), spec_h_re=z(), spec_h_im=z(),
        tail=jnp.zeros((batch, cfg.pts), jnp.float32),
        wp=jnp.asarray(0, jnp.int32),
        wp2=jnp.asarray(cfg.nparts - 1, jnp.int32),
    )


def state_shardings(mesh: Mesh):
    """NamedShardings to place a sharded-pconv state on the mesh."""
    return dict(
        spec_x_re=NamedSharding(mesh, P("dp", None, None)),
        spec_x_im=NamedSharding(mesh, P("dp", None, None)),
        spec_h_re=NamedSharding(mesh, P("dp", "tp", None)),
        spec_h_im=NamedSharding(mesh, P("dp", "tp", None)),
        tail=NamedSharding(mesh, P("dp", None)),
        wp=NamedSharding(mesh, P()),
        wp2=NamedSharding(mesh, P()),
    )


def _masked_row_update(ring: Float, row: Float, slot: Float, lo: Float) -> Float:
    """Write `row` at global ring slot `slot` into a tp-shard whose rows
    cover global indices [lo, lo + local_rows): a one-hot masked update
    (data-dependent scatter across shards without communication)."""
    local = ring.shape[-2]
    idx = lo + jnp.arange(local)
    mask = (idx == slot)[None, :, None]
    return jnp.where(mask, row[:, None, :], ring)


def make_sharded_pconv_step(cfg: _p.PconvConfig, mesh: Mesh, tv: bool = True):
    """Build a jitted sharded step:  (state, block_x[, block_h]) -> (state, out).

    blocks: (batch, pts) sharded over dp. One psum over tp per block.
    """
    nparts = cfg.nparts
    tp = mesh.shape["tp"]
    if nparts % tp:
        raise ValueError(f"nparts {nparts} must divide over tp={tp}")

    state_specs = dict(
        spec_x_re=P("dp", None, None), spec_x_im=P("dp", None, None),
        spec_h_re=P("dp", "tp", None), spec_h_im=P("dp", "tp", None),
        tail=P("dp", None), wp=P(), wp2=P(),
    )
    blk = P("dp", None)
    in_specs = (state_specs, blk, blk) if tv else (state_specs, blk)
    out_specs = (state_specs, blk)

    def body(st, bx, bh=None):
        # local shapes: spec_x (B/dp, nparts, bins); spec_h (B/dp, nparts/tp, bins)
        my_tp = jax.lax.axis_index("tp")
        lo = my_tp * (nparts // tp)

        if tv:
            both = jnp.stack([bx, bh], axis=1)             # (b, 2, pts)
            fr, fi = _p._forward_partition(cfg, both)       # (b, 2, bins)
            xr, xi = fr[:, 0], fi[:, 0]
            hr, hi = fr[:, 1], fi[:, 1]
        else:
            xr, xi = _p._forward_partition(cfg, bx)

        # replicated input-ring update (write slot wp on every tp shard)
        upd = lambda ring, row: jax.lax.dynamic_update_slice(
            ring, row[:, None, :], (0, st["wp"], 0))
        st = dict(st)
        st["spec_x_re"] = upd(st["spec_x_re"], xr)
        st["spec_x_im"] = upd(st["spec_x_im"], xi)
        if tv:
            # sharded coefficient-ring update: masked one-hot write
            st["spec_h_re"] = _masked_row_update(st["spec_h_re"], hr, st["wp2"], lo)
            st["spec_h_im"] = _masked_row_update(st["spec_h_im"], hi, st["wp2"], lo)
            st["wp2"] = (st["wp2"] - 1) % nparts
        wp = (st["wp"] + 1) % nparts
        st["wp"] = wp

        # local MAC over this shard's partition rows q in [lo, lo+local):
        # pairs x[(wp + q) % nparts] with h[q]  (cl_conv_kernels.h:104-113)
        local = nparts // tp
        q = lo + jnp.arange(local)
        idx = (wp + q) % nparts
        gxr = jnp.take(st["spec_x_re"], idx, axis=1)       # (b, local, bins)
        gxi = jnp.take(st["spec_x_im"], idx, axis=1)
        hr_, hi_ = st["spec_h_re"], st["spec_h_im"]
        acc_r = jnp.sum(gxr * hr_ - gxi * hi_, axis=1)
        acc_i = jnp.sum(gxr * hi_ + gxi * hr_, axis=1)
        b0 = 2.0 if cfg.bin0_mode == "exact" else 1.0
        acc_r = acc_r.at[:, 0].set(b0 * jnp.sum(gxr[:, :, 0] * hr_[:, :, 0], axis=1))
        acc_i = acc_i.at[:, 0].set(b0 * jnp.sum(gxi[:, :, 0] * hi_[:, :, 0], axis=1))

        # the only cross-device communication: one psum of (b, bins)
        acc_r = jax.lax.psum(acc_r, "tp")
        acc_i = jax.lax.psum(acc_i, "tp")

        y = irfft_split((acc_r, acc_i), cfg.impl)           # (b, 2*pts)
        out = (y[..., : cfg.pts] + st["tail"]) / cfg.pts
        st["tail"] = y[..., cfg.pts:]
        return st, out

    sm = jax.shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
    return jax.jit(sm)


# ---------------------------------------------------------------------------
# crossfaded IR replacement on the sharded engine
# ---------------------------------------------------------------------------

def make_sharded_pconv_xfade(cfg: _p.PconvConfig, mesh: Mesh):
    """Jitted (begin, step) for a click-free IR replacement on the
    (dp, tp)-sharded LTI engine — the sharded form of
    ``ops/pconv.pconv_begin_xfade`` / ``pconv_step_xfade``.

    ``begin(state, irs, mask)`` starts a fade for the channels where
    ``mask`` (dp-sharded, (batch,)) is True. Masked-out channels keep
    their coefficient shards and tail bitwise on BOTH fade paths, so the
    blend is algebraically a no-op for them — within f32 ulp noise, not
    bitwise: the faded step's stacked inverse is a different XLA program
    than the plain step's, so reduction orders differ (the vmapped
    ``models.Convolver.set_ir`` is where untouched channels are pinned
    bit-exact). The incoming path's OLA tail is reconstructed from the
    replicated input ring (one extra psum, once).

    ``step(xf, block, ramp)`` runs one faded block: both paths' local
    partition-MACs are stacked so the fade rides ONE psum of a
    (2, b, bins) plane — doubled collective bytes, no extra collective latency.
    When the host-side ramp schedule reaches 1, continue with the plain
    ``make_sharded_pconv_step`` step on ``xf``'s base keys (drop
    ``old_*``).
    """
    nparts, tp = cfg.nparts, mesh.shape["tp"]
    if nparts % tp:
        raise ValueError(f"nparts {nparts} must divide over tp={tp}")
    local = nparts // tp
    b0 = 2.0 if cfg.bin0_mode == "exact" else 1.0

    state_specs = dict(
        spec_x_re=P("dp", None, None), spec_x_im=P("dp", None, None),
        spec_h_re=P("dp", "tp", None), spec_h_im=P("dp", "tp", None),
        tail=P("dp", None), wp=P(), wp2=P(),
    )
    xf_specs = dict(state_specs,
                    old_h_re=P("dp", "tp", None),
                    old_h_im=P("dp", "tp", None),
                    old_tail=P("dp", None))

    def _local_mac(x_re, x_im, hr, hi, wp, lo):
        q = lo + jnp.arange(local)
        idx = (wp + q) % nparts
        gxr = jnp.take(x_re, idx, axis=1)                 # (b, local, bins)
        gxi = jnp.take(x_im, idx, axis=1)
        acc_r = jnp.sum(gxr * hr - gxi * hi, axis=1)
        acc_i = jnp.sum(gxr * hi + gxi * hr, axis=1)
        acc_r = acc_r.at[:, 0].set(
            b0 * jnp.sum(gxr[:, :, 0] * hr[:, :, 0], axis=1))
        acc_i = acc_i.at[:, 0].set(
            b0 * jnp.sum(gxi[:, :, 0] * hi[:, :, 0], axis=1))
        return acc_r, acc_i

    def begin_body(st, ir_local, mask):
        lo = jax.lax.axis_index("tp") * local
        parts = ir_local.reshape(ir_local.shape[0], nparts, cfg.pts)
        hr, hi = _p._forward_partition(cfg, parts)         # (b, nparts, bins)
        local_slots = lo + jnp.arange(local)
        src = (st["wp2"] - local_slots) % nparts           # push_ir layout
        m3 = mask[:, None, None]
        hr_sel = jnp.where(m3, jnp.take(hr, src, axis=1), st["spec_h_re"])
        hi_sel = jnp.where(m3, jnp.take(hi, src, axis=1), st["spec_h_im"])
        # incoming-path tail: re-run the previous block's MAC (read
        # pointer == current wp) against the selected coefficients
        acc_r, acc_i = _local_mac(st["spec_x_re"], st["spec_x_im"],
                                  hr_sel, hi_sel, st["wp"], lo)
        acc_r = jax.lax.psum(acc_r, "tp")
        acc_i = jax.lax.psum(acc_i, "tp")
        y = irfft_split((acc_r, acc_i), cfg.impl)
        xf = dict(st)
        xf["spec_h_re"], xf["spec_h_im"] = hr_sel, hi_sel
        xf["tail"] = jnp.where(mask[:, None], y[..., cfg.pts:], st["tail"])
        xf["old_h_re"], xf["old_h_im"] = st["spec_h_re"], st["spec_h_im"]
        xf["old_tail"] = st["tail"]
        return xf

    def step_body(xf, bx, ramp):
        lo = jax.lax.axis_index("tp") * local
        xr, xi = _p._forward_partition(cfg, bx)
        st = dict(xf)
        upd = lambda ring, row: jax.lax.dynamic_update_slice(
            ring, row[:, None, :], (0, st["wp"], 0))
        st["spec_x_re"] = upd(st["spec_x_re"], xr)
        st["spec_x_im"] = upd(st["spec_x_im"], xi)
        wp = (st["wp"] + 1) % nparts
        st["wp"] = wp
        nr, ni = _local_mac(st["spec_x_re"], st["spec_x_im"],
                            st["spec_h_re"], st["spec_h_im"], wp, lo)
        orr, oi = _local_mac(st["spec_x_re"], st["spec_x_im"],
                             st["old_h_re"], st["old_h_im"], wp, lo)
        acc_r = jax.lax.psum(jnp.stack([nr, orr]), "tp")   # (2, b, bins)
        acc_i = jax.lax.psum(jnp.stack([ni, oi]), "tp")
        y = irfft_split((acc_r, acc_i), cfg.impl)          # (2, b, 2*pts)
        out_new = (y[0, :, : cfg.pts] + st["tail"]) / cfg.pts
        out_old = (y[1, :, : cfg.pts] + st["old_tail"]) / cfg.pts
        st["tail"] = y[0, :, cfg.pts:]
        st["old_tail"] = y[1, :, cfg.pts:]
        out = out_old + ramp[None, :] * (out_new - out_old)
        return st, out

    begin = jax.shard_map(
        begin_body, mesh=mesh,
        in_specs=(state_specs, P("dp", None), P("dp")), out_specs=xf_specs)
    step = jax.shard_map(
        step_body, mesh=mesh,
        in_specs=(xf_specs, P("dp", None), P(None)),
        out_specs=(xf_specs, P("dp", None)))
    return jax.jit(begin), jax.jit(step)


def sharded_push_ir(cfg: _p.PconvConfig, mesh: Mesh, state, ir: Float):
    """Batched push_ir for the sharded state. ir: (batch, cvs)."""
    nparts, tp = cfg.nparts, mesh.shape["tp"]
    specs = dict(
        spec_h_re=P("dp", "tp", None), spec_h_im=P("dp", "tp", None), wp2=P())
    ir_spec = P("dp", None)

    def body(sub, ir_local):
        my_tp = jax.lax.axis_index("tp")
        lo = my_tp * (nparts // tp)
        parts = ir_local.reshape(ir_local.shape[0], nparts, cfg.pts)
        hr, hi = _p._forward_partition(cfg, parts)          # (b, nparts, bins)
        # push_ir writes partition p at slot (wp2 - p) % nparts; inverted,
        # the partition stored at slot s is (wp2 - s) % nparts
        local_slots = lo + jnp.arange(nparts // tp)
        src = (sub["wp2"] - local_slots) % nparts
        return dict(
            spec_h_re=jnp.take(hr, src, axis=1),
            spec_h_im=jnp.take(hi, src, axis=1),
            wp2=sub["wp2"],
        )

    sm = jax.shard_map(body, mesh=mesh, in_specs=(specs, ir_spec), out_specs=specs)
    new = sm({k: state[k] for k in ("spec_h_re", "spec_h_im", "wp2")}, ir)
    out = dict(state)
    out.update({k: new[k] for k in ("spec_h_re", "spec_h_im")})
    return out
