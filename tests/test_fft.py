"""Complex FFT core tests: numpy oracle + reference-convention roundtrips.

Stronger than the reference's eyeball-only smoke tests (test_cfft.cpp has no
assertions — SURVEY §4); tolerance bar from BASELINE.json: <= 1e-5.
"""

import jax
import numpy as np
import pytest

from opencl_fft_tpu.ops import fft
from opencl_fft_tpu.ops.cplx import from_complex, to_complex

RNG = np.random.default_rng(1234)
IMPLS = ["mm", "stockham", "xla"]
SIZES = [2, 4, 8, 16, 32, 128, 256, 1024, 4096, 16384]


def randc(shape):
    return (RNG.standard_normal(shape) + 1j * RNG.standard_normal(shape)).astype(
        np.complex64
    )


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", SIZES)
def test_forward_matches_numpy(impl, n):
    x = randc((3, n))
    got = np.asarray(fft.fft_unnormalized(x, -1, impl))
    ref = np.fft.fft(x)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", [2, 16, 1024])
def test_inverse_matches_numpy(impl, n):
    x = randc((2, n))
    got = np.asarray(fft.fft_unnormalized(x, +1, impl))
    ref = np.fft.ifft(x) * n  # unnormalized sum convention
    scale = np.max(np.abs(ref)) + 1e-20
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("n", SIZES)
def test_reference_roundtrip(impl, n):
    """cfft forward (scaled 1/N, cl_fft.cpp:39-40) then inverse == identity."""
    x = randc((n,))
    rt = np.asarray(fft.cfft(fft.cfft(x, True, impl), False, impl))
    np.testing.assert_allclose(rt, x, atol=1e-5 * np.max(np.abs(x)), rtol=0)


def test_forward_is_scaled_dft():
    """Reference forward convention: DFT / N."""
    n = 64
    x = randc((n,))
    got = np.asarray(fft.cfft(x, True))
    np.testing.assert_allclose(got, np.fft.fft(x) / n, atol=1e-6, rtol=0)


def test_impls_agree():
    x = randc((5, 512))
    outs = [np.asarray(fft.fft_unnormalized(x, -1, impl)) for impl in IMPLS]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=2e-5 * np.max(np.abs(outs[0])))


def test_batched_shapes():
    x = randc((2, 3, 4, 64))
    got = np.asarray(fft.fft_unnormalized(x, -1, "mm"))
    ref = np.fft.fft(x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, atol=2e-5 * np.max(np.abs(ref)), rtol=0)


def test_jit_and_grad_compatible():
    """The core is functional: jit-able and differentiable (split form)."""
    x = from_complex(randc((4, 128)))

    @jax.jit
    def loss(x):
        re, im = fft.fft_split(x, -1, "mm")
        return (re**2 + im**2).sum()

    g = jax.grad(loss)(x)
    assert g[0].shape == (4, 128) and np.isfinite(np.asarray(g[0])).all()


def test_linearity_and_parseval():
    n = 1024
    x, y = randc((n,)), randc((n,))
    fx = np.asarray(fft.fft_unnormalized(x, -1))
    fy = np.asarray(fft.fft_unnormalized(y, -1))
    fxy = np.asarray(fft.fft_unnormalized(x + 2 * y, -1))
    np.testing.assert_allclose(fxy, fx + 2 * fy,
                               atol=1e-5 * np.max(np.abs(fx + 2 * fy)))
    np.testing.assert_allclose(
        np.sum(np.abs(fx) ** 2) / n, np.sum(np.abs(x) ** 2), rtol=1e-5
    )


def test_invalid_args_raise():
    with pytest.raises(ValueError):
        fft.fft_unnormalized(randc((8,)), 0)
    with pytest.raises(ValueError):
        fft.fft_unnormalized(randc((8,)), -1, "nope")


@pytest.mark.parametrize("n", [3, 12, 100, 384, 1000])
def test_bluestein_non_pow2(n):
    """Beyond-parity: arbitrary sizes via Bluestein chirp-z (the reference
    is power-of-two only and rounds up, csound/opcode.cpp:30-35)."""
    x = randc((2, n))
    got = np.asarray(fft.fft_unnormalized(x, -1))
    ref = np.fft.fft(x)
    np.testing.assert_allclose(got, ref, atol=3e-5 * np.max(np.abs(ref)), rtol=0)
    inv = np.asarray(fft.fft_unnormalized(got, +1)) / n
    np.testing.assert_allclose(inv, x, atol=3e-5 * np.max(np.abs(x)), rtol=0)


def test_out_t_leaf_variant(monkeypatch):
    """The transposed-output second-leaf variant (off by default, see
    ops/fft.py _OUT_T_MIN_N2) stays correct."""
    monkeypatch.setattr(fft, "_OUT_T_MIN_N2", 64)
    for n in (4096, 65536):
        x = randc((2, n))
        got = np.asarray(fft.fft_unnormalized(x, -1, "mm"))
        ref = np.fft.fft(x)
        np.testing.assert_allclose(got, ref, atol=3e-5 * np.max(np.abs(ref)),
                                   rtol=0)


def test_gauss_leaf_variant(monkeypatch):
    """The Gauss 3-matmul complex leaf (used for Precision.HIGH leaves >=
    _GAUSS_MIN_N, off by default) stays correct both forced-on and
    forced-off, and both agree with numpy."""
    monkeypatch.setattr(fft, "_FAST_MODE", "on")   # HIGH leaves only
    for gauss_min, combo_t in ((64, False), (64, True), (1 << 30, False)):
        monkeypatch.setattr(fft, "_GAUSS_MIN_N", gauss_min)
        if combo_t:     # gauss + fused-transpose second leaf compose
            monkeypatch.setattr(fft, "_OUT_T_MIN_N2", 64)
        for n in (4096, 65536):
            x = randc((2, n))
            got = np.asarray(fft.fft_unnormalized(x, -1, "mm"))
            ref = np.fft.fft(x)
            np.testing.assert_allclose(
                got, ref, atol=3e-5 * np.max(np.abs(ref)), rtol=0)


def test_deterministic_rerun():
    """XLA reductions are deterministic (vs the reference's CAS-loop atomics,
    cl_conv_kernels.h:29-44, which are order-nondeterministic): identical
    inputs must give bitwise-identical outputs."""
    x = randc((8, 256))
    a = np.asarray(fft.fft_unnormalized(x, -1, "mm"))
    b = np.asarray(fft.fft_unnormalized(x, -1, "mm"))
    assert np.array_equal(a, b)


def test_auto_route_matches_numpy_roundtrip():
    """impl='auto' (jnp.fft) through the fft_split dispatcher matches
    numpy forward and inverse at n=2^13, batch 2."""
    n = 1 << 13
    x = randc((2, n))
    got = np.asarray(fft.fft_unnormalized(x, -1))
    ref = np.fft.fft(x)
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale, rtol=0)
    inv = np.asarray(fft.fft_unnormalized(got, +1)) / n
    np.testing.assert_allclose(inv, x, atol=1e-5 * np.max(np.abs(x)), rtol=0)


def test_auto_route_keeps_f64():
    """Under x64 the auto route stays in float64 (complex128)."""
    x = (RNG.standard_normal((1, 1 << 13))
         + 1j * RNG.standard_normal((1, 1 << 13)))
    with jax.enable_x64():
        got = fft.fft_unnormalized(x.astype(np.complex128), -1)
        assert got.dtype == np.complex128
        np.testing.assert_allclose(np.asarray(got), np.fft.fft(x),
                                   atol=1e-9 * np.abs(x).sum(), rtol=0)


@pytest.mark.parametrize("impl", IMPLS + ["auto"])
@pytest.mark.parametrize("n", [8, 96, 1024])
def test_fused_scale_matches_explicit_multiply(impl, n):
    """fft_split(..., scale=s) == s * fft_split(...) on every path
    (including the Bluestein non-pow2 core at n=96)."""
    x = randc((3, n))
    s = 0.37
    base = np.asarray(fft.fft_unnormalized(x, -1, impl))
    got = to_complex(fft.fft_split(from_complex(x), -1, impl, scale=s))
    np.testing.assert_allclose(
        np.asarray(got), s * base, atol=1e-6 * np.max(np.abs(base)), rtol=0)


def test_fused_scale_auto_route():
    """The auto route applies scale with the transform (n=2^13, s=1/n)."""
    n = 1 << 13
    x = randc((2, n))
    s = 1.0 / n
    base = np.fft.fft(x) * s
    got = to_complex(fft.fft_split(from_complex(x), -1, "auto", scale=s))
    np.testing.assert_allclose(
        np.asarray(got), base, atol=1e-5 * np.max(np.abs(base)), rtol=0)


def test_fused_scale_scalar_size_one():
    got = fft.fft_split((np.float32([2.0]), np.float32([3.0])), -1,
                        scale=0.5)
    np.testing.assert_allclose(np.asarray(got[0]), [1.0])
    np.testing.assert_allclose(np.asarray(got[1]), [1.5])


def test_turbo_mode_policy():
    """"turbo" selects pure-bf16 leaves (>=64) but never touches the
    convolution engines (exact_precision overrides it) nor small leaves,
    and restores cleanly. On CPU DEFAULT == f32, so this pins the policy
    plumbing; chip_smoke.py measures the error on the GPU."""
    import jax as _jax
    import jax.numpy as jnp

    from opencl_fft_tpu.ops import fft as F

    F.set_fast_math("turbo")
    try:
        assert F._fast_mode() == "turbo"
        assert F._leaf_precision(128) == _jax.lax.Precision.DEFAULT
        assert F._leaf_precision(32) == _jax.lax.Precision.HIGHEST
        with F.exact_precision():
            assert F._leaf_precision(128) == _jax.lax.Precision.HIGHEST
        assert F._leaf_precision(128) == _jax.lax.Precision.DEFAULT
        # numerically correct end-to-end (exact on CPU where DEFAULT=f32)
        x = RNG.standard_normal((2, 4096)).astype(np.float32)
        r, i = F.fft_split((jnp.asarray(x), jnp.zeros_like(jnp.asarray(x))),
                           -1, "mm")
        ref = np.fft.fft(x)
        err = np.abs(np.asarray(r) + 1j * np.asarray(i) - ref).max()
        assert err / np.abs(ref).max() < 1e-4
    finally:
        F.set_fast_math(None)
    assert F._fast_mode() == "auto"


def test_set_fast_math_string_modes_are_validated():
    """String args must name a mode exactly — a truthy fallthrough would
    turn set_fast_math("off") into bf16x3-everywhere silently (review
    finding r3)."""
    import jax as _jax

    from opencl_fft_tpu.ops import fft as F

    try:
        F.set_fast_math("off")
        assert F._fast_mode() == "off"
        assert F._leaf_precision(128) == _jax.lax.Precision.HIGHEST
        F.set_fast_math("on")
        assert F._fast_mode() == "on"
        F.set_fast_math("auto")
        assert F._fast_mode() == "auto"
        F.set_fast_math("TURBO")        # case-insensitive alias
        assert F._fast_mode() == "turbo"
        with pytest.raises(ValueError, match="unknown mode"):
            F.set_fast_math("fastest")
        assert F._fast_mode() == "turbo"   # rejected arg changes nothing
    finally:
        F.set_fast_math(None)


def test_exact_precision_is_thread_local():
    """exact_precision must not leak across threads (review finding r3:
    the realtime pipeline traces on a worker thread concurrently with
    the main thread)."""
    import threading
    import time as _t

    from opencl_fft_tpu.ops import fft as F

    seen = {}
    inside = threading.Event()
    release = threading.Event()

    def worker():
        with F.exact_precision():
            inside.set()
            release.wait(5)
            seen["worker_in_ctx"] = F._fast_mode()
        seen["worker_after"] = F._fast_mode()

    t = threading.Thread(target=worker)
    t.start()
    assert inside.wait(5)
    seen["main_while_worker_in_ctx"] = F._fast_mode()
    release.set()
    t.join(5)
    assert seen["worker_in_ctx"] == "off"
    assert seen["main_while_worker_in_ctx"] == "auto"
    assert seen["worker_after"] == "auto"


# ---------------------------------------------------------------------------
# Flat zero-transpose chain (_fft_mm_flat): digit order, twiddle partition,
# gauss/block leaf parity, dispatch fallback, fused scale.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("factors", [(8, 8), (16, 8), (8, 4, 8),
                                     (16, 16, 16), (8, 8, 8, 8),
                                     (32, 2, 4)])
@pytest.mark.parametrize("sign", [-1, 1])
def test_flat_matches_numpy(factors, sign):
    import jax.numpy as jnp

    from opencl_fft_tpu.ops import fft as F

    n = int(np.prod(factors))
    x = randc((3, n))
    re = jnp.asarray(x.real)
    im = jnp.asarray(x.imag)
    yr, yi = F._fft_mm_flat((re, im), sign, factors, gauss_min=1 << 30)
    ref = np.fft.fft(x) if sign == -1 else np.fft.ifft(x) * n
    got = np.asarray(yr) + 1j * np.asarray(yi)
    scale = np.max(np.abs(ref)) + 1e-20
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)


def test_flat_gauss_leaves_match_block():
    """Gauss 3-matmul leaves in the flat chain agree with the block form
    (same contract as _leaf_dft's two forms)."""
    import jax.numpy as jnp

    from opencl_fft_tpu.ops import fft as F

    factors = (64, 16, 8)
    n = int(np.prod(factors))
    x = randc((2, n))
    re = jnp.asarray(x.real)
    im = jnp.asarray(x.imag)
    br, bi = F._fft_mm_flat((re, im), -1, factors, gauss_min=1 << 30)
    gr, gi = F._fft_mm_flat((re, im), -1, factors, gauss_min=8)
    ref = np.fft.fft(x)
    scale = np.max(np.abs(ref))
    for yr, yi in ((br, bi), (gr, gi)):
        got = np.asarray(yr) + 1j * np.asarray(yi)
        np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)


def test_flat_dispatch_plan_and_fallback():
    """impl='flat' uses _FLAT_PLANS when present (with the fused scale)
    and falls back to mm for unplanned sizes."""
    import jax.numpy as jnp

    from opencl_fft_tpu.ops import fft as F

    n = 4096
    x = randc((3, n))
    re = jnp.asarray(x.real)
    im = jnp.asarray(x.imag)
    ref = np.fft.fft(x)
    scale = np.max(np.abs(ref))

    # no plan: mm fallback
    yr, yi = F.fft_split((re, im), -1, "flat")
    got = np.asarray(yr) + 1j * np.asarray(yi)
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)

    F._FLAT_PLANS[n] = (32, 16, 8)
    try:
        yr, yi = F.fft_split((re, im), -1, "flat", scale=1.0 / n)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        np.testing.assert_allclose(got, ref / n, atol=2e-5 * scale / n,
                                   rtol=0)
    finally:
        del F._FLAT_PLANS[n]


def test_flat_f64():
    import jax.numpy as jnp

    from opencl_fft_tpu.ops import fft as F
    from opencl_fft_tpu.utils.numerics import require_x64

    try:
        require_x64()
    except Exception:
        pytest.skip("x64 unavailable")
    n = 1024
    x = (RNG.standard_normal((2, n)) + 1j * RNG.standard_normal((2, n)))
    re = jnp.asarray(x.real, jnp.float64)
    im = jnp.asarray(x.imag, jnp.float64)
    yr, yi = F._fft_mm_flat((re, im), -1, (16, 8, 8), gauss_min=1 << 30)
    ref = np.fft.fft(x)
    got = np.asarray(yr) + 1j * np.asarray(yi)
    assert got.dtype == np.complex128 or np.asarray(yr).dtype == np.float64
    np.testing.assert_allclose(got, ref, atol=1e-10 * np.abs(ref).max(),
                               rtol=0)
