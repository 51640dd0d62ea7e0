"""The plain XLA routes that carry every engine shape.

Spectral MAC against a numpy MAC; the per-block step against the literal
reference model (tests/reference_model.py); the whole-scan, TV, batched
and bins=2048 streams against per-block step loops and scipy, including
segment chaining; the offline gather-MAC against a numpy sliding window
and against streaming; the default FFT route against numpy; and the
direct-FIR engine against np.convolve.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import signal as sps

from opencl_fft_tpu.ops import dconv as D
from opencl_fft_tpu.ops import fft as F
from opencl_fft_tpu.ops import pconv as P
from opencl_fft_tpu.ops.rfft import (deinterleave, interleave, irfft_split,
                                     pack_forward, rfft_split)

from reference_model import RefPconv

RNG = np.random.default_rng(55)


def _np_mac(x, h, rp, b0):
    xr, xi = x
    hr, hi = h
    np_ = xr.shape[0]
    idx = (rp + np.arange(np_)) % np_
    gxr, gxi = xr[idx], xi[idx]
    acc_r = np.sum(gxr * hr - gxi * hi, axis=0)
    acc_i = np.sum(gxr * hi + gxi * hr, axis=0)
    acc_r[0] = b0 * np.sum(gxr[:, 0] * hr[:, 0])
    acc_i[0] = b0 * np.sum(gxi[:, 0] * hi[:, 0])
    return acc_r, acc_i


def _step_loop(cfg, st, blocks, tv_blocks=None):
    """Per-block pconv_step (or pconv_step_tv) loop: the sequential oracle."""
    step = jax.jit(functools.partial(
        P.pconv_step_tv if tv_blocks is not None else P.pconv_step, cfg))
    outs = []
    for t in range(blocks.shape[0]):
        if tv_blocks is None:
            st, o = step(st, blocks[t])
        else:
            st, o = step(st, blocks[t], tv_blocks[t])
        outs.append(np.asarray(o))
    return st, np.stack(outs)


def _scale(a):
    return float(np.max(np.abs(np.asarray(a)))) + 1e-9


# ---------------------------------------------------------------------------
# spectral MAC
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nparts,bins", [(8, 128), (16, 256), (32, 512)])
@pytest.mark.parametrize("rp", [0, 1, 3, 7, 9])
@pytest.mark.parametrize("b0", [1.0, 2.0])
def test_spectral_mac_matches_numpy(nparts, bins, rp, b0):
    x = tuple(RNG.standard_normal((nparts, bins)).astype(np.float32)
              for _ in range(2))
    h = tuple(RNG.standard_normal((nparts, bins)).astype(np.float32)
              for _ in range(2))
    rp = rp % nparts
    cfg = P.PconvConfig(pts=bins, nparts=nparts,
                        bin0_mode="exact" if b0 == 2.0 else "compat")
    st = P.pconv_init(cfg)._replace(
        spec_x_re=jnp.asarray(np.concatenate([x[0], x[0]])),
        spec_x_im=jnp.asarray(np.concatenate([x[1], x[1]])),
        spec_h_re=jnp.asarray(h[0]), spec_h_im=jnp.asarray(h[1]))
    got_r, got_i = P._spectral_mac(cfg, st, jnp.int32(rp))
    exp_r, exp_i = _np_mac(x, h, rp, b0)
    np.testing.assert_allclose(np.asarray(got_r), exp_r, atol=1e-4)
    np.testing.assert_allclose(np.asarray(got_i), exp_i, atol=1e-4)


# ---------------------------------------------------------------------------
# configuration surface and routing
# ---------------------------------------------------------------------------


def test_configs_have_no_kernel_option():
    """Kernel choice is not a user option: the configs take no `pallas`."""
    with pytest.raises(TypeError):
        P.PconvConfig(pts=512, nparts=256, pallas="auto")
    with pytest.raises(TypeError):
        D.DconvConfig(irsize=512, vsize=512, pallas="auto")


def test_forward_table_gate():
    """f32 engines with pts <= _FWD_MM_MAX_PTS and impl auto/mm run the
    forward transform as one matmul; larger partitions, f64 and explicit
    FFT impls run the transform chain."""
    def prims(cfg):
        blk = jnp.zeros((cfg.pts,), jnp.float32)
        return str(jax.make_jaxpr(
            lambda b: P._forward_partition(cfg, b))(blk))

    assert "dot_general" in prims(P.PconvConfig(pts=P._FWD_MM_MAX_PTS,
                                                nparts=1))
    assert "dot_general" in prims(P.PconvConfig(pts=64, nparts=1, impl="mm"))
    big = prims(P.PconvConfig(pts=2 * P._FWD_MM_MAX_PTS, nparts=1))
    assert "dot_general" not in big and "fft" in big
    assert "fft" in prims(P.PconvConfig(pts=64, nparts=1, impl="xla"))


def test_auto_fft_route_is_jnp_fft():
    """impl='auto' lowers to the FFT primitive (cuFFT on a GPU), with no
    leaf matmuls; impl='mm' is the matmul tree."""
    x = (jnp.zeros((2, 1024)), jnp.zeros((2, 1024)))
    auto = str(jax.make_jaxpr(lambda s: F.fft_split(s, -1))(x))
    mm = str(jax.make_jaxpr(lambda s: F.fft_split(s, -1, "mm"))(x))
    assert "fft" in auto and "dot_general" not in auto
    assert "dot_general" in mm


def test_stream_accepts_any_block_count():
    """The scan takes any number of blocks (no group multiple)."""
    cfg = P.PconvConfig(pts=64, nparts=4)
    st = P.push_ir(cfg, P.pconv_init(cfg),
                   jnp.asarray(RNG.standard_normal(cfg.cvs), jnp.float32))
    for nb in (1, 7):
        blocks = jnp.asarray(RNG.standard_normal((nb, 64)), jnp.float32)
        _, out = P.pconv_stream(cfg, st, blocks)
        _, ref = _step_loop(cfg, st, blocks)
        np.testing.assert_allclose(np.asarray(out), ref,
                                   atol=1e-6 * _scale(ref))


# ---------------------------------------------------------------------------
# per-block step against the reference model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nparts,bins", [(8, 128), (16, 256), (32, 512)])
@pytest.mark.parametrize("nprime", [0, 3, 7])
def test_step_matches_reference_model(nparts, bins, nprime):
    """pconv_step (compat bin 0) == RefPconv block for block, after
    ``nprime`` priming blocks move the ring pointer."""
    cfg = P.PconvConfig(pts=bins, nparts=nparts, bin0_mode="compat")
    ir = RNG.standard_normal(cfg.cvs).astype(np.float32)
    st = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(ir))
    ref = RefPconv(cfg.cvs, bins)
    ref.push_ir(ir.astype(np.float64))
    step = jax.jit(functools.partial(P.pconv_step, cfg))
    for t in range(nprime + 2):
        blk = RNG.standard_normal(bins).astype(np.float32)
        st, out = step(st, jnp.asarray(blk))
        expect = ref.convolution(blk.astype(np.float64))
        if t >= nprime:
            np.testing.assert_allclose(np.asarray(out), expect, rtol=0,
                                       atol=2e-5 * _scale(expect))


@pytest.mark.parametrize("nparts,bins,rp", [(8, 128, 0), (16, 256, 5)])
def test_step_tail_matches_reference_model(nparts, bins, rp):
    """The overlap-add tail carried in the state equals the reference's
    (unnormalized, pre-/pts) tail after ``rp`` + 1 blocks."""
    cfg = P.PconvConfig(pts=bins, nparts=nparts, bin0_mode="compat")
    ir = RNG.standard_normal(cfg.cvs).astype(np.float32)
    st = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(ir))
    ref = RefPconv(cfg.cvs, bins)
    ref.push_ir(ir.astype(np.float64))
    for _ in range(rp + 1):
        blk = RNG.standard_normal(bins).astype(np.float32)
        st, _ = P.pconv_step(cfg, st, jnp.asarray(blk))
        ref.convolution(blk.astype(np.float64))
    np.testing.assert_allclose(np.asarray(st.tail), ref.tail, rtol=0,
                               atol=2e-5 * _scale(ref.tail))
    assert int(st.wp) == ref.wp


@pytest.mark.parametrize("tv", [False, True])
def test_step_chain_matches_reference_model(tv):
    """LTI and TV step chains (compat) track RefPconv across wraps."""
    pts, nparts, nblocks = 128, 8, 20
    cfg = P.PconvConfig(pts=pts, nparts=nparts, bin0_mode="compat")
    ref = RefPconv(cfg.cvs, pts)
    st = P.pconv_init(cfg)
    if not tv:
        ir = RNG.standard_normal(cfg.cvs).astype(np.float32) * 0.2
        st = P.push_ir(cfg, st, jnp.asarray(ir))
        ref.push_ir(ir.astype(np.float64))
    step = jax.jit(functools.partial(P.pconv_step_tv if tv else P.pconv_step,
                                     cfg))
    for _ in range(nblocks):
        b1 = RNG.standard_normal(pts).astype(np.float32)
        if tv:
            b2 = RNG.standard_normal(pts).astype(np.float32) * 0.3
            st, out = step(st, jnp.asarray(b1), jnp.asarray(b2))
            expect = ref.convolution_tv(b1.astype(np.float64),
                                        b2.astype(np.float64))
        else:
            st, out = step(st, jnp.asarray(b1))
            expect = ref.convolution(b1.astype(np.float64))
        np.testing.assert_allclose(np.asarray(out), expect, rtol=0,
                                   atol=2e-5 * (_scale(expect) + 1))


def test_forward_table_matches_transform_chain():
    """block @ _wfwd_np == rfft_split of the zero-padded frame (the
    transform chain the table replaces)."""
    pts = 128
    block = RNG.standard_normal((3, pts)).astype(np.float32)
    frame = np.concatenate([block, np.zeros_like(block)], axis=-1)
    er, ei = rfft_split(jnp.asarray(frame), "xla", unnormalized=True)
    got = block @ P._wfwd_np(pts)
    scale = _scale(got)
    np.testing.assert_allclose(got[:, :pts], np.asarray(er), atol=1e-5 * scale)
    np.testing.assert_allclose(got[:, pts:], np.asarray(ei), atol=1e-5 * scale)


def test_interleave_is_exact_inverse_of_deinterleave():
    """The time-domain (de)interleave around the half-size transforms is a
    lossless permutation."""
    for b in (128, 512):
        y = RNG.standard_normal((2, 2 * b)).astype(np.float32)
        np.testing.assert_array_equal(
            np.asarray(interleave(deinterleave(jnp.asarray(y)))), y)


# ---------------------------------------------------------------------------
# offline gather-MAC and render
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("nparts,bins,k", [(8, 128, 8), (16, 128, 20)])
def test_offline_gather_mac_matches_sliding_window(batch, nparts, bins, k):
    from opencl_fft_tpu.ops.decomposed import _lti_mac_xla

    cfg = P.PconvConfig(pts=bins, nparts=nparts)
    rows = nparts - 1 + k
    tl = RNG.standard_normal((2, batch, rows, bins)).astype(np.float32)
    h = RNG.standard_normal((2, batch, nparts, bins)).astype(np.float32)
    got_r, got_i = jax.vmap(
        lambda xr, xi, hr, hi: _lti_mac_xla(cfg, (xr, xi), (hr, hi), k, 2.0))(
        *map(jnp.asarray, (tl[0], tl[1], h[0], h[1])))
    for b in range(batch):
        for kk in range(k):
            er, ei = _np_mac((tl[0, b, kk:kk + nparts], tl[1, b, kk:kk + nparts]),
                             (h[0, b], h[1, b]), 0, 2.0)
            np.testing.assert_allclose(np.asarray(got_r)[b, kk], er, atol=1e-4)
            np.testing.assert_allclose(np.asarray(got_i)[b, kk], ei, atol=1e-4)


@pytest.mark.parametrize("nblocks", [4, 8, 20])
def test_pconv_offline_matches_streaming(nblocks):
    """pconv_offline (no sequential scan) == pconv_step streaming, for
    nblocks below, equal to, and beyond nparts."""
    pts, nparts = 128, 16
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    ir = RNG.standard_normal(pts * nparts).astype(np.float32) * 0.2
    blocks = RNG.standard_normal((nblocks, pts)).astype(np.float32)
    st = P.push_ir(cfg, P.pconv_init(cfg), ir)
    # prime with a few streamed blocks so wp != 0 and tail != 0
    for b in RNG.standard_normal((3, pts)).astype(np.float32):
        st, _ = P.pconv_step(cfg, st, b)
    st_seq, outs_seq = _step_loop(cfg, st, jnp.asarray(blocks))
    st_off, outs_off = P.pconv_offline(cfg, st, blocks)
    scale = _scale(outs_seq)
    np.testing.assert_allclose(np.asarray(outs_off), outs_seq,
                               atol=2e-5 * scale, rtol=0)
    assert int(st_off.wp) == int(st_seq.wp)
    np.testing.assert_allclose(np.asarray(st_off.tail),
                               np.asarray(st_seq.tail),
                               atol=2e-5 * _scale(st_seq.tail))
    np.testing.assert_allclose(np.asarray(st_off.spec_x_re),
                               np.asarray(st_seq.spec_x_re),
                               atol=2e-5 * _scale(st_seq.spec_x_re))
    nxt = RNG.standard_normal(pts).astype(np.float32)
    _, o_seq = P.pconv_step(cfg, st_seq, nxt)
    _, o_off = P.pconv_step(cfg, st_off, nxt)
    np.testing.assert_allclose(np.asarray(o_off), np.asarray(o_seq),
                               atol=2e-5 * scale)


# ---------------------------------------------------------------------------
# default FFT route against numpy
# ---------------------------------------------------------------------------


def _split(z):
    return (jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))


def _c(re_im):
    return np.asarray(re_im[0]) + 1j * np.asarray(re_im[1])


def _ref(z, sign, s=1.0):
    n = z.shape[-1]
    return (np.fft.fft(z) if sign == -1 else np.fft.ifft(z) * n) * s


@pytest.mark.parametrize("n", [1 << 13, 1 << 14, 1 << 16])
@pytest.mark.parametrize("sign", [-1, 1])
def test_auto_fft_matches_numpy(n, sign):
    z = RNG.standard_normal((2, n)) + 1j * RNG.standard_normal((2, n))
    got = _c(F.fft_split(_split(z), sign))
    ref = _ref(z, sign)
    np.testing.assert_allclose(got, ref, atol=1e-5 * _scale(ref), rtol=0)


@pytest.mark.parametrize("n", [1 << 13, 1 << 16])
def test_auto_fft_rerun_bit_identical(n):
    z = RNG.standard_normal((2, n)) + 1j * RNG.standard_normal((2, n))
    fn = jax.jit(lambda s: F.fft_split(s, -1, scale=1.0 / np.sqrt(n)))
    a, b = _c(fn(_split(z))), _c(fn(_split(z)))
    assert np.array_equal(a, b)


def test_auto_fft_roundtrip_and_determinism():
    n = 1 << 14
    z = RNG.standard_normal((3, n)) + 1j * RNG.standard_normal((3, n))
    fr, fi = F.fft_split(_split(z), -1)
    br, bi = F.fft_split((fr / n, fi / n), +1)
    np.testing.assert_allclose(np.asarray(br), z.real, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(bi), z.imag, atol=1e-5, rtol=0)
    r2, i2 = F.fft_split(_split(z), -1)
    assert np.array_equal(np.asarray(fr), np.asarray(r2))
    assert np.array_equal(np.asarray(fi), np.asarray(i2))


def test_xla_impl_matches_numpy_with_scale():
    """impl='xla' names the same route explicitly; scale is applied."""
    n = 1 << 14
    z = RNG.standard_normal((2, n)) + 1j * RNG.standard_normal((2, n))
    s = 1.0 / n
    got = _c(F.fft_split(_split(z), -1, "xla", scale=s))
    ref = _ref(z, -1, s)
    np.testing.assert_allclose(got, ref, atol=1e-5 * _scale(ref), rtol=0)
    with pytest.raises(ValueError):
        F.fft_split(_split(z), -1, "vmem")


@pytest.mark.parametrize("n,scaled", [(1 << 15, True), (1 << 15, False),
                                      (1 << 18, True)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_auto_fft_large_sizes(n, scaled, sign):
    z = RNG.standard_normal((2, n)) + 1j * RNG.standard_normal((2, n))
    s = 1.0 / np.sqrt(n) if scaled else 1.0
    got = _c(F.fft_split(_split(z), sign, scale=s))
    ref = _ref(z, sign, s)
    np.testing.assert_allclose(got, ref, atol=1e-5 * _scale(ref), rtol=0)


@pytest.mark.parametrize("n", [1 << 10, 1 << 11, 1 << 12, 1 << 13])
@pytest.mark.parametrize("sign", [-1, 1])
def test_auto_fft_small_sizes(n, sign):
    z = RNG.standard_normal((4, n)) + 1j * RNG.standard_normal((4, n))
    s = 1.0 / np.sqrt(n)
    got = _c(F.fft_split(_split(z), sign, scale=s))
    ref = _ref(z, sign, s)
    np.testing.assert_allclose(got, ref, atol=1e-5 * _scale(ref), rtol=0)


def test_auto_fft_batch_shapes_and_determinism():
    n = 1 << 10
    z = RNG.standard_normal((2, 3, n)) + 1j * RNG.standard_normal((2, 3, n))
    a = _c(F.fft_split(_split(z), -1))
    b = _c(F.fft_split(_split(z), -1))
    assert a.shape == z.shape and np.array_equal(a, b)
    np.testing.assert_allclose(a, np.fft.fft(z), atol=1e-5 * _scale(a))


def test_auto_fft_single_row_2_18():
    n = 1 << 18
    z = RNG.standard_normal((1, n)) + 1j * RNG.standard_normal((1, n))
    got = _c(F.fft_split(_split(z), -1))
    np.testing.assert_allclose(got, np.fft.fft(z), atol=1e-5 * _scale(got))


# ---------------------------------------------------------------------------
# whole-scan streams: LTI, TV, batched, segment chaining
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bin0_mode", ["exact", "compat"])
def test_pconv_stream_matches_step_loop_and_scipy(bin0_mode):
    """pconv_stream over two chained calls == the per-block step loop
    (outputs and continued state); in exact mode both equal scipy."""
    pts, nparts, nb = 128, 8, 20
    cfg = P.PconvConfig(pts=pts, nparts=nparts, bin0_mode=bin0_mode)
    ir = RNG.standard_normal(pts * nparts).astype(np.float32) * 0.2
    x = RNG.standard_normal(2 * nb * pts).astype(np.float32)
    blocks = jnp.asarray(x.reshape(2, nb, pts))
    st0 = P.push_ir(cfg, P.pconv_init(cfg), ir)
    st, o1 = P.pconv_stream(cfg, st0, blocks[0])
    st, o2 = P.pconv_stream(cfg, st, blocks[1])
    st_l, ref = _step_loop(cfg, st0, blocks.reshape(2 * nb, pts))
    got = np.concatenate([np.asarray(o1), np.asarray(o2)])
    np.testing.assert_allclose(got, ref, atol=1e-6 * _scale(ref), rtol=0)
    assert int(st.wp) == int(st_l.wp)
    np.testing.assert_allclose(np.asarray(st.spec_x_re),
                               np.asarray(st_l.spec_x_re), rtol=0,
                               atol=1e-6 * _scale(st_l.spec_x_re))
    if bin0_mode == "exact":
        sp = sps.fftconvolve(x.astype(np.float64), ir)[: x.size]
        np.testing.assert_allclose(got.reshape(-1), sp, rtol=0,
                                   atol=2e-5 * _scale(sp))


def test_pconv_stream_tv_matches_step_loop():
    """TV scan == per-block TV loop (outputs, h ring at decrementing wp2),
    with an odd block count and continuation across calls."""
    pts, nparts, nb = 128, 8, 21
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    bx = jnp.asarray(RNG.standard_normal((2, nb, pts)), jnp.float32)
    bh = jnp.asarray(RNG.standard_normal((2, nb, pts)) * 0.3, jnp.float32)
    st, o1 = P.pconv_stream_tv(cfg, P.pconv_init(cfg), bx[0], bh[0])
    st, o2 = P.pconv_stream_tv(cfg, st, bx[1], bh[1])
    st_l, ref = _step_loop(cfg, P.pconv_init(cfg), bx.reshape(-1, pts),
                           bh.reshape(-1, pts))
    got = np.concatenate([np.asarray(o1), np.asarray(o2)])
    np.testing.assert_allclose(got, ref, atol=1e-6 * _scale(ref), rtol=0)
    assert int(st.wp2) == int(st_l.wp2)
    np.testing.assert_allclose(np.asarray(st.spec_h_re),
                               np.asarray(st_l.spec_h_re), rtol=0,
                               atol=1e-6 * _scale(st_l.spec_h_re))


def test_stream_batched_matches_per_channel_steps():
    """Batched (multi-channel) scan == each channel's own step loop, and
    chained continuation."""
    from opencl_fft_tpu.models.convolver import _vmapped_push, batched_state

    pts, nparts, nb, B = 128, 8, 21, 3
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    irs = jnp.asarray(RNG.standard_normal((B, pts * nparts)) * 0.1,
                      jnp.float32)
    blocks = jnp.asarray(RNG.standard_normal((2, nb, B, pts)), jnp.float32)
    st = _vmapped_push(cfg)(batched_state(cfg, B), irs)
    st, o1 = P.pconv_stream_batched(cfg, st, blocks[0])
    st, o2 = P.pconv_stream_batched(cfg, st, blocks[1])
    got = np.concatenate([np.asarray(o1), np.asarray(o2)])
    for c in range(B):
        s0 = P.push_ir(cfg, P.pconv_init(cfg), irs[c])
        _, ref = _step_loop(cfg, s0, blocks[:, :, c].reshape(-1, pts))
        np.testing.assert_allclose(got[:, c], ref, rtol=0,
                                   atol=1e-5 * _scale(ref))
    assert int(st.wp) == (2 * nb) % nparts


def test_stream_batched_tv_matches_per_channel_steps():
    from opencl_fft_tpu.models.convolver import batched_state

    pts, nparts, nb, B = 128, 8, 21, 3
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    bx = jnp.asarray(RNG.standard_normal((nb, B, pts)), jnp.float32)
    bh = jnp.asarray(RNG.standard_normal((nb, B, pts)) * 0.1, jnp.float32)
    st, out = P.pconv_stream_batched_tv(cfg, batched_state(cfg, B), bx, bh)
    for c in range(B):
        st_l, ref = _step_loop(cfg, P.pconv_init(cfg), bx[:, c], bh[:, c])
        np.testing.assert_allclose(np.asarray(out)[:, c], ref, rtol=0,
                                   atol=1e-5 * _scale(ref))
        np.testing.assert_allclose(np.asarray(st.spec_h_re)[c],
                                   np.asarray(st_l.spec_h_re), rtol=0,
                                   atol=1e-5 * _scale(st_l.spec_h_re))
    assert int(st.wp) == nb % nparts
    assert int(st.wp2) == (nparts - 1 - nb) % nparts


def test_stream_batched_tv_channel_independence():
    """Channels do not interact: two half-batches give the same result as
    one full batch."""
    from opencl_fft_tpu.models.convolver import batched_state

    pts, nparts, nb, B = 128, 8, 16, 4
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    bx = jnp.asarray(RNG.standard_normal((nb, B, pts)), jnp.float32)
    bh = jnp.asarray(RNG.standard_normal((nb, B, pts)) * 0.1, jnp.float32)
    _, full = P.pconv_stream_batched_tv(cfg, batched_state(cfg, B), bx, bh)
    _, lo = P.pconv_stream_batched_tv(cfg, batched_state(cfg, 2),
                                      bx[:, :2], bh[:, :2])
    _, hi = P.pconv_stream_batched_tv(cfg, batched_state(cfg, 2),
                                      bx[:, 2:], bh[:, 2:])
    halves = np.concatenate([np.asarray(lo), np.asarray(hi)], axis=1)
    np.testing.assert_allclose(np.asarray(full), halves, rtol=0,
                               atol=1e-6 * _scale(halves))


def test_stream_segmentation_matches_single_call():
    """A long stream cut into 8-block segments (state threaded between
    calls) == one call, LTI and TV."""
    pts, nparts, nb = 128, 8, 32
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    ir = RNG.standard_normal(pts * nparts).astype(np.float32) * 0.2
    bx = jnp.asarray(RNG.standard_normal((nb, pts)), jnp.float32)
    bh = jnp.asarray(RNG.standard_normal((nb, pts)) * 0.1, jnp.float32)
    st0 = P.push_ir(cfg, P.pconv_init(cfg), ir)
    st1, o1 = P.pconv_stream(cfg, st0, bx)
    st1tv, o1tv = P.pconv_stream_tv(cfg, st0, bx, bh)
    st2, st2tv, o2, o2tv = st0, st0, [], []
    for s in range(0, nb, 8):
        st2, o = P.pconv_stream(cfg, st2, bx[s:s + 8])
        st2tv, otv = P.pconv_stream_tv(cfg, st2tv, bx[s:s + 8], bh[s:s + 8])
        o2.append(np.asarray(o))
        o2tv.append(np.asarray(otv))
    sc = _scale(o1)
    np.testing.assert_allclose(np.concatenate(o2), np.asarray(o1),
                               atol=1e-6 * sc, rtol=0)
    np.testing.assert_allclose(np.concatenate(o2tv), np.asarray(o1tv),
                               atol=1e-6 * _scale(o1tv), rtol=0)
    for a, b in zip(jax.tree.leaves(st1), jax.tree.leaves(st2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-6 * _scale(a))


def test_batched_stream_segmentation_matches_single_call():
    """Batched wrappers chained over 8-block segments == one call."""
    from opencl_fft_tpu.models.convolver import _vmapped_push, batched_state

    pts, nparts, nb, nch = 128, 8, 24, 3
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    irs = jnp.asarray(RNG.standard_normal((nch, pts * nparts)) * 0.2,
                      jnp.float32)
    st0 = jax.jit(_vmapped_push(cfg))(batched_state(cfg, nch), irs)
    bx = jnp.asarray(RNG.standard_normal((nb, nch, pts)), jnp.float32)
    bh = jnp.asarray(RNG.standard_normal((nb, nch, pts)) * 0.1, jnp.float32)
    _, o1 = P.pconv_stream_batched(cfg, st0, bx)
    _, o1tv = P.pconv_stream_batched_tv(cfg, st0, bx, bh)
    st2, st2tv, o2, o2tv = st0, st0, [], []
    for s in range(0, nb, 8):
        st2, o = P.pconv_stream_batched(cfg, st2, bx[s:s + 8])
        st2tv, otv = P.pconv_stream_batched_tv(cfg, st2tv, bx[s:s + 8],
                                               bh[s:s + 8])
        o2.append(np.asarray(o))
        o2tv.append(np.asarray(otv))
    np.testing.assert_allclose(np.concatenate(o2), np.asarray(o1),
                               atol=1e-6 * _scale(o1), rtol=0)
    np.testing.assert_allclose(np.concatenate(o2tv), np.asarray(o1tv),
                               atol=1e-6 * _scale(o1tv), rtol=0)


# ---------------------------------------------------------------------------
# bins = 2048 (the largest table-forward partition) and the packing algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [16, 64, 256])
def test_forward_table_matches_numpy_rfft(m):
    """block @ _wfwd_np(m) == the packed, unnormalized rfft of the
    zero-padded frame, from a float64 numpy oracle."""
    x = RNG.standard_normal((3, m))
    s = np.fft.rfft(np.concatenate([x, np.zeros_like(x)], axis=-1))
    packed = s[:, :m].copy()
    packed[:, 0] = 0.5 * s[:, 0].real + 0.5j * s[:, m].real
    packed[:, m // 2] = np.conj(s[:, m // 2])
    got = x.astype(np.float32) @ P._wfwd_np(m)
    sc = _scale(got)
    np.testing.assert_allclose(got[:, :m], packed.real, atol=1e-5 * sc,
                               rtol=0)
    np.testing.assert_allclose(got[:, m:], packed.imag, atol=1e-5 * sc,
                               rtol=0)


@pytest.mark.parametrize("m", [16, 64, 256])
def test_inverse_matches_numpy_irfft(m):
    """irfft_split of a packed spectrum == numpy's unnormalized irfft."""
    x = RNG.standard_normal((3, 2 * m))
    c = rfft_split(jnp.asarray(x, jnp.float32), unnormalized=True)
    y = irfft_split(c)
    np.testing.assert_allclose(np.asarray(y) / m, x, atol=1e-5 * _scale(x),
                               rtol=0)


def test_pack_matrix_matches_pack_forward():
    """The folded pack matrix == rfft.pack_forward on random spectra."""
    m = 64
    re, im = (RNG.standard_normal((2, m)) for _ in range(2))
    got = np.concatenate([re, im], axis=-1) @ P._pack_matrix_np(m)
    er, ei = pack_forward((jnp.asarray(re, jnp.float32),
                           jnp.asarray(im, jnp.float32)))
    np.testing.assert_allclose(got[:, :m], np.asarray(er), atol=1e-5)
    np.testing.assert_allclose(got[:, m:], np.asarray(ei), atol=1e-5)


def test_bins_2048_forward_route():
    """bins=2048 still takes the one-matmul forward (the largest table);
    the numbers agree with the transform chain."""
    cfg = P.PconvConfig(pts=2048, nparts=2)
    cfg_x = P.PconvConfig(pts=2048, nparts=2, impl="xla")
    blk = jnp.asarray(RNG.standard_normal((2, 2048)), jnp.float32)
    a = np.asarray(P._forward_partition(cfg, blk))
    b = np.asarray(P._forward_partition(cfg_x, blk))
    np.testing.assert_allclose(a, b, atol=1e-5 * _scale(b), rtol=0)


@pytest.mark.parametrize("bin0_mode", ["exact", "compat"])
def test_bins_2048_stream_matches_step_loop(bin0_mode):
    pts, nparts, nb = 2048, 2, 6
    cfg = P.PconvConfig(pts=pts, nparts=nparts, bin0_mode=bin0_mode)
    ir = RNG.standard_normal(pts * nparts).astype(np.float32) * 0.05
    x = RNG.standard_normal(2 * nb * pts).astype(np.float32)
    blocks = jnp.asarray(x.reshape(2, nb, pts))
    st0 = P.push_ir(cfg, P.pconv_init(cfg), ir)
    st, o1 = P.pconv_stream(cfg, st0, blocks[0])
    st, o2 = P.pconv_stream(cfg, st, blocks[1])
    _, ref = _step_loop(cfg, st0, blocks.reshape(-1, pts))
    got = np.concatenate([np.asarray(o1), np.asarray(o2)])
    np.testing.assert_allclose(got, ref, atol=1e-6 * _scale(ref), rtol=0)
    if bin0_mode == "exact":
        sp = sps.fftconvolve(x.astype(np.float64), ir)[: x.size]
        np.testing.assert_allclose(got.reshape(-1), sp, rtol=0,
                                   atol=2e-5 * _scale(sp))


def test_bins_2048_tv_matches_step_loop():
    pts, nparts, nb = 2048, 2, 7
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    bx = jnp.asarray(RNG.standard_normal((nb, pts)), jnp.float32)
    bh = jnp.asarray(RNG.standard_normal((nb, pts)) * 0.1, jnp.float32)
    st, out = P.pconv_stream_tv(cfg, P.pconv_init(cfg), bx, bh)
    st_l, ref = _step_loop(cfg, P.pconv_init(cfg), bx, bh)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=1e-6 * _scale(ref))
    assert int(st.wp2) == int(st_l.wp2)


def test_bins_2048_stream_bitwise_rerun():
    pts, nparts, nb = 2048, 2, 4
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    ir = RNG.standard_normal(pts * nparts).astype(np.float32) * 0.05
    blocks = jnp.asarray(RNG.standard_normal((nb, pts)), jnp.float32)
    st = P.push_ir(cfg, P.pconv_init(cfg), ir)
    run = jax.jit(functools.partial(P.pconv_stream, cfg))
    np.testing.assert_array_equal(np.asarray(run(st, blocks)[1]),
                                  np.asarray(run(st, blocks)[1]))


# ---------------------------------------------------------------------------
# direct FIR engine
# ---------------------------------------------------------------------------


def test_sliding_windows_rows():
    """_sliding_windows row i reads d shifted left by i."""
    d = jnp.asarray(RNG.standard_normal(256), jnp.float32)
    w = np.asarray(D._sliding_windows(d, 129, 128))
    for i in (0, 1, 64, 128):
        np.testing.assert_array_equal(w[i], np.asarray(d)[i:i + 128])


@pytest.mark.parametrize("irsize,vsize", [(128, 128), (256, 128)])
@pytest.mark.parametrize("delay_compat", [False, True])
def test_dconv_stream_matches_np_convolve(irsize, vsize, delay_compat):
    """dconv_stream over two chained calls == np.convolve (one sample
    later under delay_compat)."""
    cfg = D.DconvConfig(irsize=irsize, vsize=vsize, delay_compat=delay_compat)
    ir = RNG.standard_normal(irsize).astype(np.float32) * 0.3
    nb = 19
    x = RNG.standard_normal(2 * nb * vsize).astype(np.float32)
    blocks = jnp.asarray(x.reshape(2, nb, vsize))
    st = D.push_ir(cfg, D.dconv_init(cfg), ir)
    st, o1 = D.dconv_stream(cfg, st, blocks[0])
    st, o2 = D.dconv_stream(cfg, st, blocks[1])
    got = np.concatenate([np.asarray(o1), np.asarray(o2)]).reshape(-1)
    ref = np.convolve(x.astype(np.float64), ir)
    if delay_compat:
        ref = np.concatenate([[0.0], ref])
    ref = ref[: x.size]
    np.testing.assert_allclose(got, ref, atol=3e-5 * _scale(ref), rtol=0)
    assert int(st.wp) == (2 * nb * vsize) % cfg.ring


def test_dconv_config_validation():
    with pytest.raises(ValueError):
        D.DconvConfig(irsize=0, vsize=128)
    with pytest.raises(ValueError):
        D.DconvConfig(irsize=128, vsize=128, dtype="f16")


def test_dconv_stream_bitwise_rerun():
    cfg = D.DconvConfig(irsize=128, vsize=128)
    ir = RNG.standard_normal(128).astype(np.float32)
    blocks = jnp.asarray(RNG.standard_normal((16, 128)), jnp.float32)
    st = D.push_ir(cfg, D.dconv_init(cfg), ir)
    _, o1 = D.dconv_stream(cfg, st, blocks)
    _, o2 = D.dconv_stream(cfg, st, blocks)
    np.testing.assert_array_equal(np.asarray(o1), np.asarray(o2))
