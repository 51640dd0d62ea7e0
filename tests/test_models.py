"""Batched-model tests (models/convolver.py)."""

import numpy as np
from scipy import signal as sps

from opencl_fft_tpu.models.convolver import BatchedFFT, Convolver, TVConvolver
from opencl_fft_tpu.ops import pconv as P

RNG = np.random.default_rng(31)


def test_convolver_batch_matches_scipy():
    pts, nparts, batch = 32, 4, 3
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    conv = Convolver(cfg, batch)
    irs = RNG.standard_normal((batch, cfg.cvs)).astype(np.float32)
    conv.push_ir(irs)
    x = RNG.standard_normal((batch, cfg.cvs * 2)).astype(np.float32)
    outs = []
    for i in range(x.shape[1] // pts):
        outs.append(np.asarray(conv.step(x[:, i * pts:(i + 1) * pts])))
    got = np.concatenate(outs, axis=1)
    for b in range(batch):
        ref = sps.fftconvolve(x[b], irs[b])[: got.shape[1]]
        np.testing.assert_allclose(got[b], ref, atol=3e-5 * np.max(np.abs(ref)),
                                   rtol=0)


def test_tvconvolver_matches_single_channel_engine():
    pts, nparts, batch = 16, 4, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    tv = TVConvolver(cfg, batch)
    refs = [P.pconv_init(cfg) for _ in range(batch)]
    for _ in range(10):
        bx = RNG.standard_normal((batch, pts)).astype(np.float32)
        bh = RNG.standard_normal((batch, pts)).astype(np.float32)
        out = np.asarray(tv.step(bx, bh))
        for b in range(batch):
            refs[b], o = P.pconv_step_tv(cfg, refs[b], bx[b], bh[b])
            np.testing.assert_allclose(out[b], np.asarray(o), atol=2e-5, rtol=0)


def test_batched_fft_model():
    m = BatchedFFT(128)
    x = RNG.standard_normal((4, 128)).astype(np.float32)
    re, im = m((x, np.zeros_like(x)))
    ref = np.fft.fft(x)
    got = np.asarray(re) + 1j * np.asarray(im)
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=0)


def test_convolver_stream_matches_steps():
    pts, nparts, batch = 16, 2, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    irs = RNG.standard_normal((batch, cfg.cvs)).astype(np.float32)
    blocks = RNG.standard_normal((6, batch, pts)).astype(np.float32)

    c1 = Convolver(cfg, batch)
    c1.push_ir(irs)
    step_outs = np.stack([np.asarray(c1.step(b)) for b in blocks])

    c2 = Convolver(cfg, batch)
    c2.push_ir(irs)
    stream_outs = np.asarray(c2.stream(blocks))
    np.testing.assert_allclose(stream_outs, step_outs,
                               atol=2e-5 * np.max(np.abs(step_outs)), rtol=0)


def test_tvconvolver_stream_matches_steps():
    pts, nparts, batch = 16, 2, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    bx = RNG.standard_normal((6, batch, pts)).astype(np.float32)
    bh = RNG.standard_normal((6, batch, pts)).astype(np.float32)

    t1 = TVConvolver(cfg, batch)
    step_outs = np.stack([np.asarray(t1.step(bx[i], bh[i])) for i in range(6)])
    t2 = TVConvolver(cfg, batch)
    stream_outs = np.asarray(t2.stream(bx, bh))
    np.testing.assert_allclose(stream_outs, step_outs,
                               atol=2e-5 * np.max(np.abs(step_outs)), rtol=0)


def test_convolver_stream_chunked_matches_per_block():
    pts, nparts, batch = 16, 4, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    irs = RNG.standard_normal((batch, cfg.cvs)).astype(np.float32)
    blocks = RNG.standard_normal((8, batch, pts)).astype(np.float32)
    c1 = Convolver(cfg, batch)
    c1.push_ir(irs)
    a = np.asarray(c1.stream(blocks))
    c2 = Convolver(cfg, batch)
    c2.push_ir(irs)
    b = np.asarray(c2.stream(blocks, chunk=4))
    # same math; vmapped-scan fusion differs -> f32 noise only
    np.testing.assert_allclose(b, a, atol=2e-5 * np.max(np.abs(a)), rtol=0)
    c3 = Convolver(cfg, batch)
    c3.push_ir(irs)
    import pytest as _pt
    with _pt.raises(ValueError):
        c3.stream(blocks[:7], chunk=4)     # 7 not a multiple of 4


def test_convolver_render_matches_stream():
    """Offline render (batched transforms + gather-MAC, no sequential
    scan) == streamed per-block output within f32 tolerance, and
    streaming continues correctly from the render-produced state."""
    pts, nparts, batch = 128, 8, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    irs = (RNG.standard_normal((batch, cfg.cvs)) * 0.2).astype(np.float32)
    blocks = RNG.standard_normal((12, batch, pts)).astype(np.float32)

    c1 = Convolver(cfg, batch)
    c1.push_ir(irs)
    a = np.asarray(c1.stream(blocks))
    c2 = Convolver(cfg, batch)
    c2.push_ir(irs)
    b = np.asarray(c2.render(blocks))
    np.testing.assert_allclose(b, a, atol=2e-5 * np.max(np.abs(a)), rtol=0)
    nxt = RNG.standard_normal((batch, pts)).astype(np.float32)
    o1 = np.asarray(c1.step(nxt))
    o2 = np.asarray(c2.step(nxt))
    np.testing.assert_allclose(o2, o1, atol=2e-5 * np.max(np.abs(o1)), rtol=0)


def test_batched_state_honors_ring_dtype():
    """A Convolver built with ring_dtype='bf16' must actually allocate bf16
    ring planes (tail stays f32) — ADVICE r1: batched_state used to
    hard-code f32, silently ignoring the configured trade-off."""
    import jax.numpy as jnp
    from opencl_fft_tpu.models.convolver import batched_state

    cfg = P.PconvConfig.for_ir_length(64, 16, ring_dtype="bf16")
    st = batched_state(cfg, 3)
    assert st.spec_x_re.dtype == jnp.bfloat16
    assert st.spec_h_im.dtype == jnp.bfloat16
    assert st.tail.dtype == jnp.float32
    cfg32 = P.PconvConfig.for_ir_length(64, 16)
    assert batched_state(cfg32, 3).spec_x_re.dtype == jnp.float32


def test_batched_engine_step_matches_single_stream():
    """The batched engine's vmapped step (shared ring pointers) equals
    the single-stream pconv_step per channel."""
    import jax.numpy as jnp
    import numpy as np
    from opencl_fft_tpu.models.convolver import Convolver
    from opencl_fft_tpu.ops import pconv as P

    cfg = P.PconvConfig.for_ir_length(64 * 8, 64)
    rng = np.random.default_rng(5)
    irs = jnp.asarray(rng.standard_normal((3, 64 * 8)), jnp.float32)
    x = jnp.asarray(rng.standard_normal((3, 64)), jnp.float32)
    conv = Convolver(cfg, batch=3)
    conv.push_ir(irs)
    out = np.asarray(conv.step(x))
    assert out.shape == (3, 64)
    for c in range(3):
        st = P.push_ir(cfg, P.pconv_init(cfg), irs[c])
        _, ref = P.pconv_step(cfg, st, x[c])
        np.testing.assert_allclose(out[c], np.asarray(ref), rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_batched_stream_accepts_per_channel_ring_pointers():
    """The vmapped fallback must handle a state whose ring pointers are
    per-channel vectors (review finding r3: the closed-over vector
    crashed pconv_step's ring write at trace time). Lockstep vector
    pointers must reproduce the shared-scalar result exactly."""
    import jax.numpy as jnp

    cfg = P.PconvConfig.for_ir_length(32 * 4, 32)
    rng = np.random.default_rng(11)
    nch, nblk = 3, 6
    irs = jnp.asarray(rng.standard_normal((nch, 32 * 4)), jnp.float32)
    blocks = jnp.asarray(rng.standard_normal((nblk, nch, 32)), jnp.float32)

    conv = Convolver(cfg, batch=nch)
    conv.push_ir(irs)
    st_scalar = conv.state
    st_vec = st_scalar._replace(
        wp=jnp.full((nch,), st_scalar.wp, jnp.int32),
        wp2=jnp.full((nch,), st_scalar.wp2, jnp.int32))
    # same call style both arms (jit-vs-eager differs in low bits on CPU)
    _, out_vec = P.pconv_stream_batched(cfg, st_vec, blocks)
    _, out_scalar = P.pconv_stream_batched(cfg, st_scalar, blocks)
    np.testing.assert_array_equal(np.asarray(out_vec), np.asarray(out_scalar))

    # TV variant takes the same fallback
    tv = TVConvolver(cfg, batch=nch)
    st_tv = tv.state
    st_tv_vec = st_tv._replace(
        wp=jnp.full((nch,), st_tv.wp, jnp.int32),
        wp2=jnp.full((nch,), st_tv.wp2, jnp.int32))
    _, out_tv_vec = P.pconv_stream_batched_tv(cfg, st_tv_vec, blocks, blocks)
    _, out_tv_scalar = P.pconv_stream_batched_tv(cfg, st_tv, blocks, blocks)
    np.testing.assert_array_equal(np.asarray(out_tv_vec),
                                  np.asarray(out_tv_scalar))


def test_tvconvolver_stream_chunked_matches_stream():
    """TVConvolver.stream_chunked == stream() within f32 tolerance and
    chains state across calls (two chunked calls == one stream call)."""
    import jax.numpy as jnp

    pts, nparts, nch = 64, 8, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    rng = np.random.default_rng(15)
    nblk = 32
    bx = jnp.asarray(rng.standard_normal((nblk, nch, pts)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((nblk, nch, pts)) * 0.2, jnp.float32)

    ref = TVConvolver(cfg, batch=nch)
    out_ref = ref.stream(bx, bh)
    got = TVConvolver(cfg, batch=nch)
    out_a = got.stream_chunked(bx[:16], bh[:16], K=8)
    out_b = got.stream_chunked(bx[16:], bh[16:], K=8)
    out = np.concatenate([np.asarray(out_a), np.asarray(out_b)], axis=0)
    np.testing.assert_allclose(out, np.asarray(out_ref), atol=3e-5)
    assert int(got.state.wp2) == int(ref.state.wp2)


def test_convolver_set_ir_crossfade_per_channel():
    """Serving hot-swap: set_ir on a channel subset crossfades only those
    channels between their two exact convolutions; untouched channels are
    BIT-exactly unaffected (old == new coefficients -> the blend is a
    no-op for them)."""
    import pytest

    pts, nparts, batch, K, swap_at = 32, 4, 3, 2, 3
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    irs0 = RNG.standard_normal((batch, cfg.cvs)).astype(np.float32)
    ir_new = RNG.standard_normal((1, cfg.cvs)).astype(np.float32)
    nblocks = 10
    x = RNG.standard_normal((nblocks, batch, pts)).astype(np.float32)

    conv = Convolver(cfg, batch)
    conv.push_ir(irs0)
    # bit-exactness oracle for untouched channels: an identical engine
    # that never swaps
    ref = Convolver(cfg, batch)
    ref.push_ir(irs0)

    outs, refs = [], []
    for i in range(nblocks):
        if i == swap_at:
            conv.set_ir(ir_new, channels=[1], fade_blocks=K)
        outs.append(np.asarray(conv.step(x[i])))
        refs.append(np.asarray(ref.step(x[i])))
    got = np.stack(outs)          # (nblocks, batch, pts)
    unswapped = np.stack(refs)

    # untouched channels: bitwise equal to the never-swapped engine
    np.testing.assert_array_equal(got[:, 0], unswapped[:, 0])
    np.testing.assert_array_equal(got[:, 2], unswapped[:, 2])

    # swapped channel: blended then pure-new, vs scipy
    xs = x[:, 1].reshape(-1)
    y_old = sps.fftconvolve(xs, irs0[1])[: nblocks * pts]
    y_new = sps.fftconvolve(xs, ir_new[0])[: nblocks * pts]
    r = np.zeros(nblocks * pts, np.float32)
    f0, f1 = swap_at * pts, (swap_at + K) * pts
    r[f0:f1] = (np.arange(K * pts) + 1) / np.float32(K * pts)
    r[f1:] = 1.0
    expect = (1 - r) * y_old + r * y_new
    np.testing.assert_allclose(got[:, 1].reshape(-1), expect,
                               atol=3e-5 * np.max(np.abs(expect)), rtol=0)

    # bulk paths refuse to run mid-fade
    conv.set_ir(ir_new, channels=[0], fade_blocks=4)
    with pytest.raises(RuntimeError, match="crossfade"):
        conv.stream(x)
    with pytest.raises(RuntimeError, match="crossfade"):
        conv.render(x)


def test_convolver_set_ir_instant_and_validation():
    import pytest

    pts, nparts, batch = 32, 2, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    conv = Convolver(cfg, batch)
    irs = RNG.standard_normal((batch, cfg.cvs)).astype(np.float32)
    conv.push_ir(irs)
    x = RNG.standard_normal((batch, pts)).astype(np.float32)
    conv.step(x)

    # instant swap of every channel == push_ir semantics
    new = RNG.standard_normal((batch, cfg.cvs)).astype(np.float32)
    conv.set_ir(new, fade_blocks=0)
    ref = Convolver(cfg, batch)
    ref.push_ir(irs)
    ref.step(x)
    ref.push_ir(new)
    x2 = RNG.standard_normal((batch, pts)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(conv.step(x2)),
                                  np.asarray(ref.step(x2)))

    with pytest.raises(ValueError, match="channels=None"):
        conv.set_ir(new[:1])
    with pytest.raises(ValueError, match="indices"):
        conv.set_ir(new, channels=[0, 1, 1][:2] + [1])   # duplicate
    with pytest.raises(ValueError, match="out of range"):
        conv.set_ir(new[:1], channels=[5])
    with pytest.raises(ValueError, match="irs must be"):
        conv.set_ir(np.zeros((1, 7), np.float32), channels=[0])


def test_matrix_convolver_true_stereo():
    """MatrixConvolver: out[o] = sum_i conv(in[i], ir[o,i]) — the true-
    stereo topology as ONE batched engine; matches scipy per entry."""
    from opencl_fft_tpu.models.convolver import MatrixConvolver

    pts, nparts, n_in, n_out = 32, 4, 2, 2
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    irs = RNG.standard_normal((n_out, n_in, cfg.cvs)).astype(np.float32)
    nblocks = 8
    x = RNG.standard_normal((nblocks, n_in, pts)).astype(np.float32)

    m = MatrixConvolver(cfg, n_in, n_out)
    m.push_ir(irs)
    got = np.stack([np.asarray(m.step(x[i])) for i in range(nblocks)])

    xs = x.transpose(1, 0, 2).reshape(n_in, -1)       # (n_in, T)
    for o in range(n_out):
        ref = sum(sps.fftconvolve(xs[i], irs[o, i])[: nblocks * pts]
                  for i in range(n_in))
        np.testing.assert_allclose(got[:, o].reshape(-1), ref,
                                   atol=5e-5 * np.max(np.abs(ref)), rtol=0)

    # stream() matches step-by-step
    m2 = MatrixConvolver(cfg, n_in, n_out)
    m2.push_ir(irs)
    got2 = np.asarray(m2.stream(x))
    np.testing.assert_allclose(got2, got, atol=1e-5 * np.max(np.abs(got)),
                               rtol=0)


def test_matrix_convolver_entry_hot_swap():
    """Swapping one matrix entry crossfades only that path; the other
    entries are bit-exactly unaffected."""
    from opencl_fft_tpu.models.convolver import MatrixConvolver

    pts, nparts, K, start = 32, 4, 2, 3
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    irs = RNG.standard_normal((2, 2, cfg.cvs)).astype(np.float32)
    new = RNG.standard_normal((1, cfg.cvs)).astype(np.float32)
    nblocks = 10
    x = RNG.standard_normal((nblocks, 2, pts)).astype(np.float32)

    m = MatrixConvolver(cfg, 2, 2)
    m.push_ir(irs)
    outs = []
    for i in range(nblocks):
        if i == start:
            m.set_ir(new, entries=[(1, 0)], fade_blocks=K)
        outs.append(np.asarray(m.step(x[i])))
    got = np.stack(outs)

    xs = x.transpose(1, 0, 2).reshape(2, -1)
    T = nblocks * pts
    # out 0 is untouched: equals the static matrix row
    ref0 = sum(sps.fftconvolve(xs[i], irs[0, i])[:T] for i in range(2))
    np.testing.assert_allclose(got[:, 0].reshape(-1), ref0,
                               atol=5e-5 * np.max(np.abs(ref0)), rtol=0)
    # out 1 blends only the (1,0) path; (1,1) stays
    y_old = sps.fftconvolve(xs[0], irs[1, 0])[:T]
    y_new = sps.fftconvolve(xs[0], new[0])[:T]
    r = np.zeros(T, np.float32)
    f0, f1 = start * pts, (start + K) * pts
    r[f0:f1] = (np.arange(K * pts) + 1) / np.float32(K * pts)
    r[f1:] = 1.0
    ref1 = (1 - r) * y_old + r * y_new \
        + sps.fftconvolve(xs[1], irs[1, 1])[:T]
    np.testing.assert_allclose(got[:, 1].reshape(-1), ref1,
                               atol=5e-5 * np.max(np.abs(ref1)), rtol=0)

    import pytest
    with pytest.raises(ValueError, match="out of range"):
        m.set_ir(new, entries=[(2, 0)])
