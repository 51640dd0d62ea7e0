"""float64 paths — the analog of the reference's -DUSE_DOUBLE build flag
(macos-build.sh:5, MYFLT width), validated here on the CPU backend under
jax_enable_x64. The GPU backend runs them too (chip_smoke.py, phase f64)."""

import numpy as np
import pytest
from jax import enable_x64

from opencl_fft_tpu.ops import rfft
from opencl_fft_tpu.ops.fft import cfft, fft_split

RNG = np.random.default_rng(7)


@pytest.mark.parametrize("n", [16, 1024, 65536])
def test_cfft_f64_roundtrip(n):
    with enable_x64():
        x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)).astype(
            np.complex128)
        spec = cfft(x, forward=True)
        assert spec.dtype == np.complex128
        back = np.asarray(cfft(spec, forward=False))
        assert np.max(np.abs(back - x)) <= 1e-12 * np.max(np.abs(x))


@pytest.mark.parametrize("n", [256, 4096])
def test_fft_f64_matches_numpy(n):
    with enable_x64():
        re = RNG.standard_normal((2, n))
        im = RNG.standard_normal((2, n))
        fr, fi = fft_split((re, im), -1)
        assert fr.dtype == np.float64
        got = np.asarray(fr) + 1j * np.asarray(fi)
        ref = np.fft.fft(re + 1j * im)
        assert np.max(np.abs(got - ref)) <= 1e-10 * np.max(np.abs(ref))


def test_fft_f64_nonpow2_bluestein():
    with enable_x64():
        n = 240
        re = RNG.standard_normal(n)
        fr, fi = fft_split((re, np.zeros(n)), -1)
        got = np.asarray(fr) + 1j * np.asarray(fi)
        ref = np.fft.fft(re)
        assert np.max(np.abs(got - ref)) <= 1e-10 * np.max(np.abs(ref))


@pytest.mark.parametrize("n", [64, 8192, 65536])
def test_rfft_f64_roundtrip(n):
    with enable_x64():
        r = RNG.standard_normal((2, n))
        packed = rfft.rfft(r)
        assert packed.dtype == np.complex128
        back = np.asarray(rfft.irfft(packed))
        assert back.dtype == np.float64
        assert np.max(np.abs(back - r)) <= 1e-12 * np.max(np.abs(r))


def test_rfft_f64_matches_numpy():
    with enable_x64():
        n = 2048
        r = RNG.standard_normal(n)
        m = n // 2
        packed = np.asarray(rfft.rfft(r)) * m
        std = np.asarray(rfft.packed_to_standard(packed))
        ref = np.fft.rfft(r)
        assert np.max(np.abs(std - ref)) <= 1e-10 * np.max(np.abs(ref))


def test_f32_unaffected_by_x64_mode():
    """f32 inputs stay f32 even when x64 is on (no silent promotion)."""
    with enable_x64():
        re = RNG.standard_normal(64).astype(np.float32)
        fr, fi = fft_split((re, np.zeros(64, np.float32)), -1)
        assert fr.dtype == np.float32


def test_pconv_f64_matches_numpy_tight():
    """Partitioned streaming convolution at double width: error vs the f64
    numpy oracle collapses from f32's ~1e-5 to <=1e-12."""
    with enable_x64():
        from opencl_fft_tpu.ops import pconv as P

        x = RNG.standard_normal(2048)
        h = RNG.standard_normal(512)
        cfg = P.PconvConfig.for_ir_length(512, 64, dtype="f64")
        st = P.push_ir(cfg, P.pconv_init(cfg), h)
        assert st.spec_h_re.dtype == np.float64
        nb = 2048 // 64
        _, out = P.pconv_stream(cfg, st, x.reshape(nb, 64))
        got = np.asarray(out).reshape(-1)
        ref = np.convolve(x, h)[: got.size]
        assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_dconv_f64_matches_numpy_tight():
    with enable_x64():
        from opencl_fft_tpu.ops import dconv as D

        x = RNG.standard_normal(1024)
        h = RNG.standard_normal(128)
        cfg = D.DconvConfig(irsize=128, vsize=64, dtype="f64")
        st = D.push_ir(cfg, D.dconv_init(cfg), h)
        _, out = D.dconv_stream(cfg, st, x.reshape(-1, 64))
        got = np.asarray(out).reshape(-1)
        ref = np.convolve(x, h)[: got.size]
        assert got.dtype == np.float64
        assert np.max(np.abs(got - ref)) <= 1e-12 * np.max(np.abs(ref))


def test_f64_rejects_reduced_ring():
    from opencl_fft_tpu.ops import pconv as P

    with pytest.raises(ValueError):
        P.PconvConfig(pts=16, nparts=4, dtype="f64", ring_dtype="bf16")
