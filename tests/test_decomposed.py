"""Decomposed (batch-transform) streaming engine vs the sequential scan.

The scan (pconv_step / pconv_step_tv chained) is the oracle: it is
itself pinned bit-for-bit against the literal numpy model of the
reference kernels (tests/reference_model.py). The decomposed path and
its chunked gather-MACs must reproduce it within f32 reduction-order
tolerance, across LTI/TV, chunked state chaining, nb < nparts, and
mid-stream ring-pointer values.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from opencl_fft_tpu.ops import pconv as P
from opencl_fft_tpu.ops.decomposed import stream_decomposed


def _mk(pts, nparts, seed=0, **kw):
    cfg = P.PconvConfig(pts=pts, nparts=nparts, **kw)
    rng = np.random.default_rng(seed)
    ir = rng.standard_normal(cfg.cvs).astype(np.float32) * 0.3
    st = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(ir))
    return cfg, st, rng


def _scan_lti(cfg, st, blocks):
    def body(s, b):
        return P.pconv_step(cfg, s, b)
    return jax.lax.scan(body, st, blocks)


def _scan_tv(cfg, st, bx, bh):
    def body(s, b):
        return P.pconv_step_tv(cfg, s, b[0], b[1])
    return jax.lax.scan(body, st, jnp.stack([bx, bh], axis=1))


@pytest.mark.parametrize("nparts,nb", [(16, 40), (16, 7), (8, 64),
                                       (32, 12), (16, 16)])
def test_decomposed_lti_matches_scan(nparts, nb):
    cfg, st, rng = _mk(64, nparts)
    blocks = jnp.asarray(rng.standard_normal((nb, 64)), jnp.float32)
    st_s, out_s = _scan_lti(cfg, st, blocks)
    st_d, out_d = stream_decomposed(cfg, st, blocks)
    np.testing.assert_allclose(out_d, out_s, atol=2e-5)
    np.testing.assert_allclose(st_d.tail, st_s.tail, atol=2e-4)
    assert int(st_d.wp) == int(st_s.wp)
    np.testing.assert_allclose(st_d.spec_x_re, st_s.spec_x_re, atol=2e-5)
    np.testing.assert_allclose(st_d.spec_x_im, st_s.spec_x_im, atol=2e-5)


@pytest.mark.parametrize("nparts,nb", [(16, 40), (16, 7), (8, 64),
                                       (32, 12), (16, 16), (16, 3)])
def test_decomposed_tv_matches_scan(nparts, nb):
    cfg, st, rng = _mk(64, nparts, seed=1)
    bx = jnp.asarray(rng.standard_normal((nb, 64)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((nb, 64)) * 0.2, jnp.float32)
    st_s, out_s = _scan_tv(cfg, st, bx, bh)
    st_d, out_d = stream_decomposed(cfg, st, bx, bh)
    np.testing.assert_allclose(out_d, out_s, atol=2e-5)
    np.testing.assert_allclose(st_d.tail, st_s.tail, atol=2e-4)
    assert int(st_d.wp) == int(st_s.wp)
    assert int(st_d.wp2) == int(st_s.wp2)
    np.testing.assert_allclose(st_d.spec_h_re, st_s.spec_h_re, atol=2e-5)
    np.testing.assert_allclose(st_d.spec_h_im, st_s.spec_h_im, atol=2e-5)
    np.testing.assert_allclose(st_d.spec_x_re, st_s.spec_x_re, atol=2e-5)


def test_decomposed_tv_chaining_matches_one_call():
    """Two chained decomposed calls == one call == the scan, exercising
    mid-stream wp/wp2 values (the pairing's wp2 absorption)."""
    cfg, st, rng = _mk(64, 16, seed=2)
    bx = jnp.asarray(rng.standard_normal((37, 64)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((37, 64)) * 0.2, jnp.float32)
    st_s, out_s = _scan_tv(cfg, st, bx, bh)
    st_a, out_a = stream_decomposed(cfg, st, bx[:21], bh[:21])
    st_b, out_b = stream_decomposed(cfg, st_a, bx[21:], bh[21:])
    out_d = jnp.concatenate([out_a, out_b], axis=0)
    np.testing.assert_allclose(out_d, out_s, atol=3e-5)
    assert int(st_b.wp2) == int(st_s.wp2)
    np.testing.assert_allclose(st_b.spec_h_re, st_s.spec_h_re, atol=2e-5)


def test_decomposed_lti_chaining_matches_one_call():
    cfg, st, rng = _mk(64, 16, seed=3)
    blocks = jnp.asarray(rng.standard_normal((29, 64)), jnp.float32)
    st_s, out_s = _scan_lti(cfg, st, blocks)
    st_a, out_a = stream_decomposed(cfg, st, blocks[:11])
    st_b, out_b = stream_decomposed(cfg, st_a, blocks[11:])
    out_d = jnp.concatenate([out_a, out_b], axis=0)
    np.testing.assert_allclose(out_d, out_s, atol=3e-5)
    np.testing.assert_allclose(st_b.tail, st_s.tail, atol=2e-4)


def test_decomposed_compat_bin0():
    cfg, st, rng = _mk(64, 16, seed=4, bin0_mode="compat")
    blocks = jnp.asarray(rng.standard_normal((24, 64)), jnp.float32)
    st_s, out_s = _scan_lti(cfg, st, blocks)
    _, out_d = stream_decomposed(cfg, st, blocks)
    np.testing.assert_allclose(out_d, out_s, atol=2e-5)


# ---------------------------------------------------------------------------
# chunked XLA gather-MACs (ops/decomposed._lti_mac_xla / _tv_mac_xla)
# against the scan, at 128-sample partitions
# ---------------------------------------------------------------------------

def _primed(cfg, st, rng, c, tv):
    """Stream c blocks first so the ring pointers sit mid-ring: wp = c,
    wp2 = nparts-1-c (coefficient-ring phase c)."""
    if c == 0:
        return st
    bx = jnp.asarray(rng.standard_normal((c, cfg.pts)), jnp.float32)
    if tv:
        bh = jnp.asarray(rng.standard_normal((c, cfg.pts)) * 0.2,
                         jnp.float32)
        return _scan_tv(cfg, st, bx, bh)[0]
    return _scan_lti(cfg, st, bx)[0]


@pytest.mark.parametrize("nparts,nb", [(16, 24), (32, 8), (64, 40),
                                       (16, 11)])
def test_lti_gather_mac_matches_scan(nparts, nb):
    cfg, st, rng = _mk(128, nparts, seed=5)
    blocks = jnp.asarray(rng.standard_normal((nb, 128)), jnp.float32)
    _, out_s = _scan_lti(cfg, st, blocks)
    _, out_d = stream_decomposed(cfg, st, blocks)
    np.testing.assert_allclose(out_d, out_s, atol=2e-5)


@pytest.mark.parametrize("nparts,nb", [(16, 24), (32, 8), (64, 40),
                                       (16, 11), (16, 64), (32, 80),
                                       (64, 96)])
def test_tv_gather_mac_matches_scan(nparts, nb):
    cfg, st, rng = _mk(128, nparts, seed=6)
    bx = jnp.asarray(rng.standard_normal((nb, 128)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((nb, 128)) * 0.2, jnp.float32)
    st_s, out_s = _scan_tv(cfg, st, bx, bh)
    st_d, out_d = stream_decomposed(cfg, st, bx, bh)
    np.testing.assert_allclose(out_d, out_s, atol=2e-5)
    np.testing.assert_allclose(st_d.spec_h_re, st_s.spec_h_re, atol=2e-5)


@pytest.mark.parametrize("c", [8, 16, 24])
def test_tv_gather_mac_phase(c):
    """General coefficient-ring phase c (wp2 = nparts-1-c): gather == scan."""
    nparts, nb = 32, 24
    cfg, st, rng = _mk(128, nparts, seed=7)
    st = _primed(cfg, st, rng, c, tv=True)
    assert int(st.wp2) == (nparts - 1 - c) % nparts
    bx = jnp.asarray(rng.standard_normal((nb, 128)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((nb, 128)) * 0.2, jnp.float32)
    _, out_s = _scan_tv(cfg, st, bx, bh)
    _, out_d = stream_decomposed(cfg, st, bx, bh)
    np.testing.assert_allclose(out_d, out_s, atol=2e-5)


def test_decomposed_tv_kernel_route_chaining():
    """Chained in multiples of 8 from a fresh stream: two decomposed calls
    == the scan, including the coefficient ring."""
    cfg, st, rng = _mk(128, 16, seed=8)
    bx = jnp.asarray(rng.standard_normal((40, 128)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((40, 128)) * 0.2, jnp.float32)
    st_s, out_s = _scan_tv(cfg, st, bx, bh)
    st_a, out_a = stream_decomposed(cfg, st, bx[:16], bh[:16])
    st_b, out_b = stream_decomposed(cfg, st_a, bx[16:], bh[16:])
    out_d = jnp.concatenate([out_a, out_b], axis=0)
    np.testing.assert_allclose(out_d, out_s, atol=3e-5)
    np.testing.assert_allclose(st_b.spec_h_re, st_s.spec_h_re, atol=2e-5)


def test_gather_mac_chunk_size_is_invisible(monkeypatch):
    """The outputs-per-chunk bound (_XLA_MAC_CHUNK) only bounds memory: a
    chunk size that does not divide nb gives the same result."""
    import opencl_fft_tpu.ops.decomposed as DC

    cfg, st, rng = _mk(128, 64, seed=9)
    bx = jnp.asarray(rng.standard_normal((40, 128)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((40, 128)) * 0.2, jnp.float32)
    _, lti8 = stream_decomposed(cfg, st, bx)
    _, tv8 = stream_decomposed(cfg, st, bx, bh)
    monkeypatch.setattr(DC, "_XLA_MAC_CHUNK", 3)
    _, lti3 = stream_decomposed(cfg, st, bx)
    _, tv3 = stream_decomposed(cfg, st, bx, bh)
    np.testing.assert_allclose(lti3, lti8, atol=1e-5)
    np.testing.assert_allclose(tv3, tv8, atol=1e-5)


def test_chunked_mac_trims_partial_chunk():
    """_chunked_mac evaluates ceil(nb/K) chunks and returns exactly nb rows
    in time order."""
    from opencl_fft_tpu.ops.decomposed import _XLA_MAC_CHUNK, _chunked_mac

    nb, bins = 2 * _XLA_MAC_CHUNK + 3, 4

    def chunk(t0):
        t = (t0 + jnp.arange(_XLA_MAC_CHUNK))[:, None].astype(jnp.float32)
        return jnp.broadcast_to(t, (_XLA_MAC_CHUNK, bins)), -jnp.ones(
            (_XLA_MAC_CHUNK, bins))

    r, i = _chunked_mac(nb, bins, chunk)
    assert r.shape == (nb, bins) and i.shape == (nb, bins)
    np.testing.assert_array_equal(np.asarray(r)[:, 0], np.arange(nb))


def test_pconv_stream_is_the_scan():
    """pconv_stream / pconv_stream_tv are the per-block scan (no other
    route): they match a plain scan of pconv_step / pconv_step_tv."""
    cfg, st, rng = _mk(128, 16, seed=9)
    bx = jnp.asarray(rng.standard_normal((24, 128)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((24, 128)) * 0.2, jnp.float32)
    _, out_s = _scan_lti(cfg, st, bx)
    _, out_m = P.pconv_stream(cfg, st, bx)
    np.testing.assert_allclose(out_m, out_s, atol=1e-6)
    _, out_st = _scan_tv(cfg, st, bx, bh)
    _, out_mt = P.pconv_stream_tv(cfg, st, bx, bh)
    np.testing.assert_allclose(out_mt, out_st, atol=1e-6)


def test_stream_routing_ignores_backend():
    """The engines pick no route by backend: the traced program of
    pconv_stream is the same scan whatever jax.default_backend() says."""
    import functools
    import unittest.mock as mock

    cfg, st, rng = _mk(128, 16, seed=10)
    bx = jnp.asarray(rng.standard_normal((16, 128)), jnp.float32)
    fn = functools.partial(P.pconv_stream, cfg)
    cpu = str(jax.make_jaxpr(fn)(st, bx))
    with mock.patch.object(jax, "default_backend", return_value="gpu"):
        gpu = str(jax.make_jaxpr(fn)(st, bx))
    assert cpu == gpu
    assert "scan" in cpu


def test_offline_batched_matches_single_channel():
    """The channel-batched offline render == the single-stream offline
    render per channel."""
    from opencl_fft_tpu.models.convolver import batched_state, _vmapped_push

    pts, nparts, nb, B = 128, 16, 24, 3
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    rng = np.random.default_rng(10)
    irs = jnp.asarray(rng.standard_normal((B, cfg.cvs)) * 0.2, jnp.float32)
    blocks = jnp.asarray(rng.standard_normal((nb, B, pts)), jnp.float32)
    stb = _vmapped_push(cfg)(batched_state(cfg, B), irs)
    _, outb = P._offline_batched(cfg, stb, blocks)
    for c in range(B):
        st = P.push_ir(cfg, P.pconv_init(cfg), irs[c])
        _, out = P.pconv_offline(cfg, st, blocks[:, c])
        np.testing.assert_allclose(outb[:, c], out, atol=1e-5)


@pytest.mark.parametrize("c", [0, 8])
def test_tv_batched_decomposed_matches_single(c):
    """The channel-batched TV decomposed engine == the single-stream one
    per channel, at the fresh-stream phase and a mid-ring phase."""
    from opencl_fft_tpu.models.convolver import batched_state
    from opencl_fft_tpu.ops.decomposed import stream_batched_tv_decomposed

    pts, nparts, nb, B = 128, 16, 24, 3
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    rng = np.random.default_rng(11)
    bx = jnp.asarray(rng.standard_normal((c + nb, B, pts)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((c + nb, B, pts)) * 0.2, jnp.float32)
    stb = batched_state(cfg, B)
    if c:
        stb, _ = P.pconv_stream_batched_tv(cfg, stb, bx[:c], bh[:c])
    _, outb = stream_batched_tv_decomposed(cfg, stb, bx[c:], bh[c:])
    for ch in range(B):
        st = P.pconv_init(cfg)
        if c:
            st, _ = _scan_tv(cfg, st, bx[:c, ch], bh[:c, ch])
        _, out = stream_decomposed(cfg, st, bx[c:, ch], bh[c:, ch])
        np.testing.assert_allclose(outb[:, ch], out, atol=1e-5)


def test_offline_render_deep_ring_matches_scan():
    """pconv_offline at a deep ring (nparts=64, nb > nparts) from a
    mid-stream state == the scan, outputs and continued state."""
    cfg, st, rng = _mk(128, 64, seed=12)
    st = _primed(cfg, st, rng, 5, tv=False)
    blocks = jnp.asarray(rng.standard_normal((80, 128)), jnp.float32)
    st_s, out_s = _scan_lti(cfg, st, blocks)
    st_o, out_o = P.pconv_offline(cfg, st, blocks)
    np.testing.assert_allclose(out_o, out_s, atol=2e-5)
    assert int(st_o.wp) == int(st_s.wp)
    np.testing.assert_allclose(st_o.spec_x_re, st_s.spec_x_re, atol=2e-5)


def test_offline_batched_wide_batch_matches_vmapped_scan():
    """A wide channel batch through the offline engine == the vmapped
    per-block scan."""
    from opencl_fft_tpu.models.convolver import batched_state, _vmapped_push

    pts, nparts, nb, B = 64, 8, 20, 8
    cfg = P.PconvConfig(pts=pts, nparts=nparts)
    rng = np.random.default_rng(13)
    irs = jnp.asarray(rng.standard_normal((B, cfg.cvs)) * 0.2, jnp.float32)
    blocks = jnp.asarray(rng.standard_normal((nb, B, pts)), jnp.float32)
    stb = _vmapped_push(cfg)(batched_state(cfg, B), irs)
    st_s, out_s = P.pconv_stream_batched(cfg, stb, blocks)
    st_o, out_o = P._offline_batched(cfg, stb, blocks)
    np.testing.assert_allclose(out_o, out_s, atol=2e-5)
    assert int(st_o.wp) == int(st_s.wp)


def test_batched_tv_chunked_matches_vmapped_scan():
    """pconv_stream_batched_tv_chunked == the vmapped per-block TV scan
    within f32 tolerance, including exact state chaining across chunks
    (wp AND wp2 walks)."""
    from opencl_fft_tpu.models.convolver import batched_state, _vmapped_push

    pts, nparts, B, K, nblk = 128, 16, 3, 8, 32
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    rng = np.random.default_rng(13)
    irs = jnp.asarray(rng.standard_normal((B, cfg.cvs)) * 0.2, jnp.float32)
    st0 = _vmapped_push(cfg)(batched_state(cfg, B), irs)
    bx = jnp.asarray(rng.standard_normal((nblk, B, pts)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((nblk, B, pts)) * 0.2, jnp.float32)

    st_ref, out_ref = P.pconv_stream_batched_tv(cfg, st0, bx, bh)
    st_c, out_c = P.pconv_stream_batched_tv_chunked(cfg, st0, bx, bh, K=K)
    np.testing.assert_allclose(out_c, out_ref, atol=3e-5)
    # tails are stored unnormalized (scale ~pts): relative tolerance
    np.testing.assert_allclose(st_c.tail, st_ref.tail, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(st_c.spec_x_re, st_ref.spec_x_re, atol=2e-5)
    np.testing.assert_allclose(st_c.spec_h_re, st_ref.spec_h_re, atol=2e-5)
    assert int(st_c.wp) == int(st_ref.wp)
    assert int(st_c.wp2) == int(st_ref.wp2)


def test_batched_tv_chunked_off_phase_chaining():
    """A K=4 chunk size walks wp2 through phases that are not multiples
    of 8 mid-stream; the chunk engine must still chain."""
    from opencl_fft_tpu.models.convolver import batched_state, _vmapped_push

    pts, nparts, B, K, nblk = 128, 16, 2, 4, 24
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    rng = np.random.default_rng(14)
    irs = jnp.asarray(rng.standard_normal((B, cfg.cvs)) * 0.2, jnp.float32)
    st0 = _vmapped_push(cfg)(batched_state(cfg, B), irs)
    bx = jnp.asarray(rng.standard_normal((nblk, B, pts)), jnp.float32)
    bh = jnp.asarray(rng.standard_normal((nblk, B, pts)) * 0.2, jnp.float32)
    st_ref, out_ref = P.pconv_stream_batched_tv(cfg, st0, bx, bh)
    st_c, out_c = P.pconv_stream_batched_tv_chunked(cfg, st0, bx, bh, K=K)
    np.testing.assert_allclose(out_c, out_ref, atol=3e-5)
    assert int(st_c.wp2) == int(st_ref.wp2)


def test_batched_chunked_matches_vmapped_scan():
    """pconv_stream_batched_chunked == the vmapped per-block scan within
    f32 tolerance, including exact state chaining across chunks."""
    from opencl_fft_tpu.models.convolver import batched_state, _vmapped_push

    pts, nparts, B, K, nblk = 128, 16, 3, 8, 32
    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    rng = np.random.default_rng(12)
    irs = jnp.asarray(rng.standard_normal((B, cfg.cvs)) * 0.2, jnp.float32)
    st0 = _vmapped_push(cfg)(batched_state(cfg, B), irs)
    blocks = jnp.asarray(rng.standard_normal((nblk, B, pts)), jnp.float32)

    st_ref, out_ref = P.pconv_stream_batched(cfg, st0, blocks)
    st_c, out_c = P.pconv_stream_batched_chunked(cfg, st0, blocks, K=K)
    np.testing.assert_allclose(out_c, out_ref, atol=3e-5)
    np.testing.assert_allclose(st_c.tail, st_ref.tail, atol=2e-4)
    np.testing.assert_allclose(st_c.spec_x_re, st_ref.spec_x_re, atol=2e-5)
    assert int(st_c.wp) == int(st_ref.wp)
