"""End-to-end smoke run of the FFT and convolution paths on one GPU.

Drives the main entry points at the sizes users run, compares every
output with a float64 numpy/scipy oracle, and prints per phase the error
relative to max|ref| beside its tolerance, the compile (or first-call)
time and the warm time. Exits non-zero, without a result line, when no
GPU is present or any phase fails.

    python chip_smoke.py            # phases 1-9 on one GPU
    python chip_smoke.py --four     # the (dp, tp) mesh paths on four GPUs
    python chip_smoke.py --out results.json   # also write all rows as JSON

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
The phase functions take their sizes as arguments, so tests can run them
small on the CPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

SR = 48000

# nvidia-smi query printed before the result line (card name, power limit)
SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


class PhaseError(RuntimeError):
    """A phase produced a wrong or unusable result."""


# ---------------------------------------------------------------------------
# Device, reporting and timing helpers
# ---------------------------------------------------------------------------

def require_gpu(devices) -> None:
    """Refuse to run anywhere but a GPU backend."""
    if not devices or devices[0].platform != "gpu":
        plat = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform {plat!r})")


def parse_smi_line(line: str):
    """'NVIDIA H100 80GB HBM3, 700.00 W' -> ('NVIDIA H100 80GB HBM3',
    '700.00 W'). The name may itself contain commas; the limit is the
    last field."""
    name, sep, limit = line.strip().rpartition(",")
    if not sep or not name.strip() or not limit.strip():
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), limit.strip()


def smi_lines() -> list:
    """Card name and power limit per GPU, read by a child process that
    does not import JAX."""
    out = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout
    lines = [ln for ln in out.splitlines() if ln.strip()]
    for ln in lines:
        parse_smi_line(ln)
    return lines


def result_line(devices) -> str:
    """The final JSON line."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def rel_err(got, ref) -> float:
    got = np.asarray(got)
    got = got.astype(np.complex128 if np.iscomplexobj(got) else np.float64)
    ref = np.asarray(ref)
    if got.shape != ref.shape:
        raise PhaseError(f"shape {got.shape} != expected {ref.shape}")
    if not np.all(np.isfinite(got)):
        raise PhaseError("non-finite output")
    scale = float(np.max(np.abs(ref))) or 1.0
    return float(np.max(np.abs(got - ref))) / scale


class Report:
    """Collects checks and timings; prints one line each."""

    def __init__(self):
        self.rows = []
        self.failed = []

    def check(self, phase, name, got, ref, tol, **extra):
        err = rel_err(got, ref)
        ok = err <= tol
        row = dict(phase=phase, name=name, err=err, tol=tol, ok=ok, **extra)
        self.rows.append(row)
        print(f"[{phase}] {name}: rel_err={err:.3e} tol={tol:.0e} "
              f"{'ok' if ok else 'FAIL'}"
              + "".join(f" {k}={_fmt(v)}" for k, v in extra.items()),
              flush=True)
        if not ok:
            self.failed.append(f"{phase}/{name}")
        return err

    def note(self, phase, name, **extra):
        self.rows.append(dict(phase=phase, name=name, **extra))
        print(f"[{phase}] {name}:"
              + "".join(f" {k}={_fmt(v)}" for k, v in extra.items()),
              flush=True)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _block(x):
    import jax
    return jax.block_until_ready(x)


def compile_and_time(fn, *args, reps=5):
    """(compile_s, warm_median_s, out) for jax.jit(fn) at these args.
    Warm = median over ``reps`` calls, each ending in block_until_ready."""
    import jax
    t0 = time.perf_counter()
    comp = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = _block(comp(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(comp(*args))
        times.append(time.perf_counter() - t0)
    return compile_s, statistics.median(times), out


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def _ir(rng, n, decay_s=0.5):
    """Exponentially decaying noise: a synthetic reverb tail."""
    t = np.arange(n) / SR
    return (rng.standard_normal(n) * np.exp(-t / decay_s)).astype(np.float32)


# ---------------------------------------------------------------------------
# float64 oracles
# ---------------------------------------------------------------------------

def packed_rfft_ref(x: np.ndarray) -> np.ndarray:
    """Reference packed spectrum of Clrfft's forward transform (scaled by
    2/N): bin 0 = (DC/2, Nyq/2), bin M/2 conjugated (ops/rfft.py)."""
    n = x.shape[-1]
    m = n // 2
    s = np.fft.rfft(np.asarray(x, np.float64)) * (2.0 / n)
    p = s[..., :m].copy()
    p[..., 0] = 0.5 * s[..., 0].real + 0.5j * s[..., m].real
    p[..., m // 2] = np.conj(s[..., m // 2])
    return p


def tv_ref(bx: np.ndarray, bh: np.ndarray, nparts: int) -> np.ndarray:
    """float64 model of the time-varying engine from a fresh state
    (exact bin-0 mode): the dual ring walk of cl_conv.cpp:460-548 —
    input frames written at wp (incrementing), coefficient frames at wp2
    (decrementing), MAC sum_q X[(wp+q) % nparts] * H[q], inverse and
    overlap-add. Spectra are standard rfft bins of the zero-padded
    2*pts frames, so every product is an exact circular convolution."""
    nb, pts = bx.shape
    fx = np.fft.rfft(np.asarray(bx, np.float64), n=2 * pts)
    fh = np.fft.rfft(np.asarray(bh, np.float64), n=2 * pts)
    xr = np.zeros((nparts, pts + 1), np.complex128)
    hr = np.zeros((nparts, pts + 1), np.complex128)
    wp, wp2 = 0, nparts - 1
    tail = np.zeros(pts)
    out = np.zeros((nb, pts))
    q = np.arange(nparts)
    for t in range(nb):
        xr[wp] = fx[t]
        hr[wp2] = fh[t]
        wp = (wp + 1) % nparts
        wp2 = (wp2 - 1) % nparts
        acc = np.sum(xr[(wp + q) % nparts] * hr, axis=0)
        y = np.fft.irfft(acc, n=2 * pts)
        out[t] = y[:pts] + tail
        tail = y[pts:]
    return out


def _conv_ref(x, ir, n=None):
    from scipy.signal import fftconvolve
    y = fftconvolve(np.asarray(x, np.float64), np.asarray(ir, np.float64))
    return y if n is None else y[:n]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_fft(rep, c2c_n=1024, rfft_sizes=range(10, 17),
              batched_sizes=range(10, 21), batch_bytes=32 << 20, reps=5):
    """Clcfft / Clrfft parity sizes, batched fft_split(auto) 2^10..2^20,
    and the auto (jnp.fft) route timed against the mm matmul tree."""
    import jax.numpy as jnp

    from opencl_fft_tpu import api
    from opencl_fft_tpu.ops import fft as F

    rng = np.random.default_rng(1)
    x = (rng.standard_normal(c2c_n) + 1j * rng.standard_normal(c2c_n))
    buf = x.astype(np.complex64)
    fwd = api.Clcfft(0, c2c_n, True)
    t0 = time.perf_counter()
    fwd.transform(buf)
    first = time.perf_counter() - t0
    rep.check("fft", f"Clcfft fwd N={c2c_n}", buf, np.fft.fft(x) / c2c_n,
              1e-5, first_call_s=first)
    spec = np.fft.fft(x) / c2c_n
    buf = spec.astype(np.complex64)
    api.Clcfft(0, c2c_n, False).transform(buf)
    rep.check("fft", f"Clcfft inv N={c2c_n}", buf, x, 1e-5)

    for logn in rfft_sizes:
        n = 1 << logn
        r = rng.standard_normal(n)
        c = np.zeros(n // 2, np.complex64)
        api.Clrfft(0, n, True).transform(c, r.astype(np.float32))
        ref = packed_rfft_ref(r)
        rep.check("fft", f"Clrfft fwd N=2^{logn}", c, ref, 1e-5)
        back = np.zeros(n, np.float32)
        api.Clrfft(0, n, False).transform(ref.astype(np.complex64), back)
        rep.check("fft", f"Clrfft inv N=2^{logn}", back, r, 1e-5)

    for logn in batched_sizes:
        n = 1 << logn
        batch = max(1, batch_bytes // (8 * n))
        z = (rng.standard_normal((batch, n))
             + 1j * rng.standard_normal((batch, n)))
        sp = (jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))
        ref = np.fft.fft(z)
        tol = 1e-5 if logn <= 16 else 1e-4
        times = {}
        for impl in ("auto", "mm"):
            cs, ws, (re, im) = compile_and_time(
                lambda s, impl=impl: F.fft_split(s, -1, impl), sp, reps=reps)
            times[impl] = ws
            rep.check("fft", f"fft_split {impl} 2^{logn} x{batch}",
                      np.asarray(re) + 1j * np.asarray(im), ref,
                      tol if impl == "auto" else 1e-4,
                      compile_s=cs, warm_us=ws * 1e6,
                      gflops=5 * n * logn * batch / ws / 1e9)
        rep.note("fft", f"route 2^{logn}", auto_us=times["auto"] * 1e6,
                 mm_us=times["mm"] * 1e6,
                 mm_over_auto=times["mm"] / times["auto"])

    # reduced-precision leaf modes of the matmul path (set_fast_math)
    n = 1 << 12
    z = rng.standard_normal((8, n)) + 1j * rng.standard_normal((8, n))
    sp = (jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))
    for mode in ("on", "turbo"):
        F.set_fast_math(mode)
        try:
            re, im = F.fft_split(sp, -1, "mm")
            err = rel_err(np.asarray(re) + 1j * np.asarray(im), np.fft.fft(z))
        finally:
            F.set_fast_math(None)
        rep.note("fft", f"set_fast_math({mode!r}) mm 2^12", rel_err=err)


def phase_pconv(rep, ir_len=1 << 17, parts=512, host_block=64,
                seconds=5.0, scan_blocks=1880, split_pts=2048,
                split_len=1 << 18, reps=5):
    """Headline: ClconvProcessor fed host blocks, pconv_stream scan over
    ``scan_blocks`` blocks (three FFT routes timed), one pconv_step per
    call, and the bins=2048 whole scan."""
    import jax.numpy as jnp
    from functools import partial

    from opencl_fft_tpu.ops import pconv as P
    from opencl_fft_tpu.stream import ClconvProcessor

    rng = np.random.default_rng(2)
    ir = _ir(rng, ir_len)
    nsamp = int(seconds * SR) // host_block * host_block
    x = (rng.standard_normal(nsamp) * 0.1).astype(np.float32)
    proc = ClconvProcessor(ir, parts=parts, block_size=host_block)
    nhost = nsamp // host_block
    # the first engine call (compile) lands on the parts/host_block-th block
    warm = parts // host_block
    outs = []
    t0 = time.perf_counter()
    for i in range(warm):
        outs.append(proc.process(x[i * host_block:(i + 1) * host_block]))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(warm, nhost):
        outs.append(proc.process(x[i * host_block:(i + 1) * host_block]))
    wall = time.perf_counter() - t0
    # the processor carries one partition of latency (opcode.cpp:240-249)
    ref = np.concatenate([np.zeros(parts), _conv_ref(x, ir, nsamp - parts)])
    rep.check("pconv", f"ClconvProcessor {ir_len} taps @{parts} "
              f"({host_block}-sample host blocks, {seconds:g} s)",
              np.concatenate(outs), ref, 1e-5, first_call_s=first,
              us_per_host_block=wall / (nhost - warm) * 1e6,
              rt_factor=(nhost - warm) * host_block / SR / wall)

    cfg = P.PconvConfig.for_ir_length(ir_len, parts)
    st = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(ir))
    xs = (rng.standard_normal(scan_blocks * parts) * 0.1).astype(np.float32)
    blocks = jnp.asarray(xs.reshape(scan_blocks, parts))
    ref = _conv_ref(xs, ir, xs.size).reshape(scan_blocks, parts)
    for impl in ("auto", "xla", "mm"):
        c = P.PconvConfig.for_ir_length(ir_len, parts, impl=impl)
        cs, ws, (_, y) = compile_and_time(partial(P.pconv_stream, c),
                                          st, blocks, reps=reps)
        per_block = ws / scan_blocks
        rep.check("pconv", f"pconv_stream impl={impl} {scan_blocks} blocks",
                  y, ref, 1e-5, compile_s=cs,
                  us_per_block=per_block * 1e6,
                  rt_factor=(parts / SR) / per_block)
    cs, ws, (_, y) = compile_and_time(partial(P.pconv_step, cfg), st,
                                      blocks[0], reps=max(reps, 20))
    rep.check("pconv", "pconv_step (one block per call)", y, ref[0], 1e-5,
              compile_s=cs, us_per_call=ws * 1e6)

    # bins=2048 whole scan (the largest one-matmul forward table) against
    # a cuFFT forward
    sir = _ir(rng, split_len)
    nb = max(8, scan_blocks * parts // split_pts)
    sx = (rng.standard_normal(nb * split_pts) * 0.1).astype(np.float32)
    sref = _conv_ref(sx, sir, sx.size).reshape(nb, split_pts)
    for impl in ("auto", "xla"):
        scfg = P.PconvConfig.for_ir_length(split_len, split_pts, impl=impl)
        sst = P.push_ir(scfg, P.pconv_init(scfg), jnp.asarray(sir))
        cs, ws, (_, y) = compile_and_time(
            partial(P.pconv_stream, scfg), sst,
            jnp.asarray(sx.reshape(nb, split_pts)), reps=reps)
        rep.check("pconv", f"pconv_stream impl={impl} {split_len} taps "
                  f"@{split_pts} {nb} blocks", y, sref, 1e-5, compile_s=cs,
                  us_per_block=ws / nb * 1e6,
                  rt_factor=(split_pts / SR) / (ws / nb))


def phase_tv(rep, size=1 << 17, parts=512, host_block=64, seconds=2.0,
             scan_blocks=940, reps=5):
    """CltvconvProcessor fed host blocks of both operands, and the TV
    scan, against the float64 ring-walk model."""
    import jax.numpy as jnp
    from functools import partial

    from opencl_fft_tpu.ops import pconv as P
    from opencl_fft_tpu.stream import CltvconvProcessor

    nparts = size // parts
    rng = np.random.default_rng(3)
    nsamp = int(seconds * SR) // parts * parts
    a = (rng.standard_normal(nsamp) * 0.1).astype(np.float32)
    b = (rng.standard_normal(nsamp) * 0.1).astype(np.float32)
    proc = CltvconvProcessor(parts, size, block_size=host_block)
    nhost = nsamp // host_block
    warm = parts // host_block
    outs = []
    t0 = time.perf_counter()
    for i in range(nhost):
        if i == warm:
            first = time.perf_counter() - t0
            t0 = time.perf_counter()
        sl = slice(i * host_block, (i + 1) * host_block)
        outs.append(proc.process(a[sl], b[sl]))
    wall = time.perf_counter() - t0
    got = np.concatenate(outs)
    eng = tv_ref(a.reshape(-1, parts), b.reshape(-1, parts), nparts)
    ref = np.concatenate([np.zeros(parts), eng.reshape(-1)[:nsamp - parts]])
    rep.check("tv", f"CltvconvProcessor {size} @{parts} ({seconds:g} s)",
              got, ref, 1e-5, first_call_s=first,
              rt_factor=(nhost - warm) * host_block / SR / wall)

    cfg = P.PconvConfig.for_ir_length(size, parts)
    bx = (rng.standard_normal((scan_blocks, parts)) * 0.1).astype(np.float32)
    bh = (rng.standard_normal((scan_blocks, parts)) * 0.1).astype(np.float32)
    cs, ws, (_, y) = compile_and_time(
        partial(P.pconv_stream_tv, cfg), P.pconv_init(cfg),
        jnp.asarray(bx), jnp.asarray(bh), reps=reps)
    per_block = ws / scan_blocks
    rep.check("tv", f"pconv_stream_tv {scan_blocks} blocks", y,
              tv_ref(bx, bh, nparts), 1e-5, compile_s=cs,
              us_per_block=per_block * 1e6,
              rt_factor=(parts / SR) / per_block)


def phase_long_ir(rep, pts=512, ir_len=1 << 22, timed_blocks=200, reps=3):
    """M=512, L=2^22 through pconv_stream: the ring is primed with
    nparts blocks (so the whole IR contributes), then ``timed_blocks``
    blocks are timed and checked."""
    import jax.numpy as jnp
    from functools import partial

    from opencl_fft_tpu.ops import pconv as P

    rng = np.random.default_rng(4)
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    ir = (rng.standard_normal(ir_len) * 0.01).astype(np.float32)
    st = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(ir))
    nprime = cfg.nparts
    xs = (rng.standard_normal((nprime + timed_blocks) * pts) * 0.1
          ).astype(np.float32)
    blocks = jnp.asarray(xs.reshape(-1, pts))
    st1, y0 = P.pconv_stream(cfg, st, blocks[:nprime])
    cs, ws, (_, y1) = compile_and_time(partial(P.pconv_stream, cfg), st1,
                                       blocks[nprime:], reps=reps)
    ref = _conv_ref(xs, ir, xs.size).reshape(-1, pts)
    per_block = ws / timed_blocks
    rep.check("long-ir", f"pconv_stream {ir_len} taps @{pts} "
              f"(nparts={cfg.nparts}, {timed_blocks} blocks after "
              f"{nprime} priming)",
              np.concatenate([np.asarray(y0), np.asarray(y1)]), ref, 1e-4,
              compile_s=cs, us_per_block=per_block * 1e6,
              rt_factor=(pts / SR) / per_block)


def phase_serving(rep, batch=64, pts=512, ir_len=1 << 17, nblocks=256,
                  swap=(3, 40), fade_blocks=8, after=16, K=8, reps=3):
    """models.Convolver with independent IRs per channel: stream,
    a set_ir hot-swap of ``swap`` channels, and the K-chunked engine."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from opencl_fft_tpu import models
    from opencl_fft_tpu.models.convolver import _vmapped_push, batched_state
    from opencl_fft_tpu.ops import pconv as P

    rng = np.random.default_rng(5)
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    irs = np.stack([_ir(rng, ir_len) for _ in range(batch)]) * 0.2
    total = nblocks + after
    xs = (rng.standard_normal((total, batch, pts)) * 0.1).astype(np.float32)
    new_irs = np.stack([_ir(rng, ir_len) for _ in swap]) * 0.2

    conv = models.Convolver(cfg, batch)
    conv.push_ir(irs)
    ref_conv = models.Convolver(cfg, batch)
    ref_conv.push_ir(irs)
    t0 = time.perf_counter()
    out1 = np.asarray(conv.stream(xs[:nblocks]))
    first = time.perf_counter() - t0
    ref1 = np.asarray(ref_conv.stream(xs[:nblocks]))
    conv.set_ir(new_irs, channels=list(swap), fade_blocks=fade_blocks)
    out2 = np.stack([np.asarray(conv.step(xs[nblocks + i]))
                     for i in range(after)])
    ref2 = np.stack([np.asarray(ref_conv.step(xs[nblocks + i]))
                     for i in range(after)])
    full = np.concatenate([out1, out2])
    spot = [c for c in (0, batch // 3, 2 * batch // 3, batch - 1)
            if c not in swap]
    for c in spot:
        ref = _conv_ref(xs[:, c].reshape(-1), irs[c], total * pts)
        rep.check("serving", f"channel {c} vs scipy",
                  full[:, c].reshape(-1), ref, 1e-5)
    untouched = [c for c in range(batch) if c not in swap]
    d = np.abs(out2[:, untouched] - ref2[:, untouched]).max()
    rep.check("serving", "untouched channels across set_ir",
              out2[:, untouched], ref2[:, untouched], 1e-6,
              bit_equal=bool(d == 0))
    for c in swap:
        # after the fade the output is the new IR over the whole history
        ref = _conv_ref(xs[:, c].reshape(-1), new_irs[swap.index(c)],
                        total * pts).reshape(total, pts)
        rep.check("serving", f"swapped channel {c} after fade",
                  out2[fade_blocks:, c], ref[nblocks + fade_blocks:], 1e-5)

    st0 = jax.jit(_vmapped_push(cfg))(batched_state(cfg, batch),
                                      jnp.asarray(irs))
    blocks = jnp.asarray(xs[:nblocks])
    cs, ws, (_, y) = compile_and_time(partial(P.pconv_stream_batched, cfg),
                                      st0, blocks, reps=reps)
    rep.check("serving", f"pconv_stream_batched {batch} ch x {nblocks}",
              y, ref1, 1e-6, first_stream_s=first, compile_s=cs,
              us_per_block=ws / nblocks * 1e6,
              audio_s_per_s=batch * nblocks * pts / SR / ws)
    cs, ws, (_, y) = compile_and_time(
        partial(P.pconv_stream_batched_chunked, cfg, K=K), st0, blocks,
        reps=reps)
    rep.check("serving", f"pconv_stream_batched_chunked K={K}", y, ref1,
              1e-5, compile_s=cs, us_per_block=ws / nblocks * 1e6,
              audio_s_per_s=batch * nblocks * pts / SR / ws)


def phase_offline(rep, ir_len=1 << 17, pts=512, seconds=10.0,
                  fir=512, fir_block=512, fir_blocks=940, zl_block=64,
                  zl_seconds=1.0, reps=3):
    """pconv_offline and convolve_oneshot renders, the direct FIR
    engine, and the zero-added-latency processor."""
    import jax.numpy as jnp
    from functools import partial

    from opencl_fft_tpu.ops import dconv as D
    from opencl_fft_tpu.ops import pconv as P
    from opencl_fft_tpu.stream import ClconvProcessor

    rng = np.random.default_rng(6)
    ir = _ir(rng, ir_len)
    nb = int(seconds * SR) // pts
    x = (rng.standard_normal(nb * pts) * 0.1).astype(np.float32)
    ref_full = _conv_ref(x, ir)
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    st = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(ir))
    blocks = jnp.asarray(x.reshape(nb, pts))
    for name, fn in (("pconv_offline", P.pconv_offline),
                     ("pconv_stream", P.pconv_stream)):
        cs, ws, (_, y) = compile_and_time(partial(fn, cfg), st, blocks,
                                          reps=reps)
        rep.check("offline", f"{name} {seconds:g} s", y,
                  ref_full[:nb * pts].reshape(nb, pts), 1e-5, compile_s=cs,
                  warm_s=ws, rt_factor=seconds / ws)
    cs, ws, y = compile_and_time(P.convolve_oneshot, jnp.asarray(x),
                                 jnp.asarray(ir), reps=reps)
    rep.check("offline", f"convolve_oneshot {seconds:g} s", y, ref_full,
              1e-5, compile_s=cs, warm_s=ws, rt_factor=seconds / ws)

    for irsize in (fir, 2 * fir):
        dcfg = D.DconvConfig(irsize=irsize, vsize=fir_block)
        h = (rng.standard_normal(irsize) * 0.1).astype(np.float32)
        dst = D.push_ir(dcfg, D.dconv_init(dcfg), jnp.asarray(h))
        xd = (rng.standard_normal(fir_blocks * fir_block) * 0.1
              ).astype(np.float32)
        cs, ws, (_, y) = compile_and_time(
            partial(D.dconv_stream, dcfg), dst,
            jnp.asarray(xd.reshape(fir_blocks, fir_block)), reps=reps)
        per_block = ws / fir_blocks
        rep.check("offline", f"dconv_stream {irsize}-tap @{fir_block}",
                  np.asarray(y).reshape(-1),
                  np.convolve(xd.astype(np.float64), h)[:xd.size], 1e-5,
                  compile_s=cs, us_per_block=per_block * 1e6,
                  rt_factor=(fir_block / SR) / per_block)

    zl = ClconvProcessor(ir, parts=0, block_size=zl_block)
    nz = int(zl_seconds * SR) // zl_block
    xz = (rng.standard_normal(nz * zl_block) * 0.1).astype(np.float32)
    t0 = time.perf_counter()
    outs = [zl.process(xz[:zl_block])]
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(1, nz):
        outs.append(zl.process(xz[i * zl_block:(i + 1) * zl_block]))
    wall = time.perf_counter() - t0
    rep.check("offline", f"ClconvProcessor(parts=0) zero latency "
              f"{zl_seconds:g} s @{zl_block}", np.concatenate(outs),
              _conv_ref(xz, ir, xz.size), 1e-5, first_call_s=first,
              us_per_host_block=wall / (nz - 1) * 1e6,
              rt_factor=(nz - 1) * zl_block / SR / wall)


def phase_pipeline(rep, pts=512, ir_len=1 << 17, seconds=2.0, prime=2):
    """RealtimePipeline driven by the wall-clock-paced VirtualHost."""
    from opencl_fft_tpu.ops import pconv as P
    from opencl_fft_tpu.runtime.hosts import PipelineCallback, VirtualHost
    from opencl_fft_tpu.runtime.pipeline import RealtimePipeline

    rng = np.random.default_rng(7)
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    ir = _ir(rng, ir_len)
    sig = (rng.standard_normal(int(SR * seconds)) * 0.1).astype(np.float32)
    pos = [0]

    def source(n):
        s = np.zeros(n, np.float32)
        take = min(n, sig.size - pos[0])
        if take > 0:
            s[:take] = sig[pos[0]:pos[0] + take]
            pos[0] += take
        return s

    nframes = sig.size // pts
    with RealtimePipeline(cfg, ir=ir, prime_blocks=prime,
                          capacity_blocks=16) as pipe:
        pipe.push(np.zeros(pts, np.float32))
        pipe.wait_for_blocks(1, timeout=300)      # compile off the clock
        cb = PipelineCallback(pipe)
        host = VirtualHost(cb, sr=SR, frames=pts, source=source)
        with host:
            while len(host.captured) < nframes:
                time.sleep(0.01)
    out = host.output()
    delay = (prime + 1) * pts
    n = min(out.size - delay, sig.size)
    ref = _conv_ref(sig, ir, n)
    rep.check("pipeline", f"RealtimePipeline + VirtualHost {seconds:g} s",
              out[delay:delay + n], ref, 1e-5,
              underrun_samples=pipe.underrun_samples,
              overrun_samples=pipe.overrun_samples,
              late_callbacks=host.late_callbacks,
              blocks=pipe.blocks_processed)
    if pipe.underrun_samples or pipe.overrun_samples:
        rep.failed.append("pipeline/xruns")


def phase_f64(rep, n=1 << 16, pts=512, nparts=32, nblocks=64):
    """float64 on the device: a C2C roundtrip and a dtype="f64" stream."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from opencl_fft_tpu.ops import fft as F
    from opencl_fft_tpu.ops import pconv as P
    from opencl_fft_tpu.utils.numerics import ilog2

    rng = np.random.default_rng(8)
    with jax.enable_x64():
        z = rng.standard_normal((4, n)) + 1j * rng.standard_normal((4, n))
        sp = (jnp.asarray(z.real), jnp.asarray(z.imag))
        re, im = F.cfft_split(sp, True)
        if re.dtype != jnp.float64:
            raise PhaseError(f"f64 FFT returned {re.dtype}")
        rep.check("f64", f"cfft f64 fwd 2^{ilog2(n)}",
                  np.asarray(re) + 1j * np.asarray(im), np.fft.fft(z) / n,
                  1e-12)
        br, bi = F.cfft_split((re, im), False)
        rep.check("f64", "cfft f64 roundtrip",
                  np.asarray(br) + 1j * np.asarray(bi), z, 1e-12)
        cfg = P.PconvConfig(pts=pts, nparts=nparts, dtype="f64")
        ir = rng.standard_normal(cfg.cvs) * 0.1
        x = rng.standard_normal(nblocks * pts) * 0.1
        st = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(ir))
        cs, ws, (_, y) = compile_and_time(
            partial(P.pconv_stream, cfg), st,
            jnp.asarray(x.reshape(nblocks, pts)))
        if y.dtype != jnp.float64:
            raise PhaseError(f"f64 stream returned {y.dtype}")
        rep.check("f64", f"pconv_stream f64 {cfg.cvs} taps @{pts}",
                  np.asarray(y).reshape(-1), _conv_ref(x, ir, x.size), 1e-12,
                  compile_s=cs, us_per_block=ws / nblocks * 1e6)


def phase_determinism(rep, ir_len=1 << 17, pts=512, nblocks=470, K=8,
                      chunk_blocks=64):
    """Headline stream twice in one process (bit for bit), and
    pconv_chunk against sequential pconv_step."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from opencl_fft_tpu.ops import pconv as P

    rng = np.random.default_rng(9)
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    ir = _ir(rng, ir_len)
    st = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(ir))
    blocks = jnp.asarray(
        (rng.standard_normal((nblocks, pts)) * 0.1).astype(np.float32))
    run = jax.jit(partial(P.pconv_stream, cfg))
    a = np.asarray(run(st, blocks)[1])
    b = np.asarray(run(st, blocks)[1])
    rep.note("determinism", "pconv_stream rerun", bit_equal=bool(
        np.array_equal(a, b)), max_abs_diff=float(np.abs(a - b).max()))
    if not np.array_equal(a, b):
        rep.failed.append("determinism/rerun")

    step = jax.jit(partial(P.pconv_step, cfg))
    chunk = jax.jit(partial(P.pconv_chunk, cfg))
    s1, s2 = st, st
    seq, chk = [], []
    for i in range(chunk_blocks):
        s1, o = step(s1, blocks[i])
        seq.append(np.asarray(o))
    for i in range(0, chunk_blocks, K):
        s2, o = chunk(s2, blocks[i:i + K])
        chk.append(np.asarray(o))
    seq = np.stack(seq)
    chk = np.concatenate(chk)
    diff = float(np.abs(seq - chk).max())
    rep.check("determinism", f"pconv_chunk K={K} vs pconv_step", chk, seq,
              1e-6, bit_equal=bool(diff == 0.0), max_abs_diff=diff)


def phase_four(rep, ndev=4, batch=64, pts=512, ir_len=1 << 17,
               long_len=1 << 22, nblocks=64, fft_n=1 << 20, reps=5):
    """The (dp, tp) mesh paths on ``ndev`` devices, each compared in the
    same process with the one-device engine or numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS

    from opencl_fft_tpu import models
    from opencl_fft_tpu.ops import pconv as P
    from opencl_fft_tpu.ops.fft import fft_split
    from opencl_fft_tpu.parallel import sharded
    from opencl_fft_tpu.parallel.dist_fft import dist_fft_split
    from opencl_fft_tpu.parallel.mesh import make_mesh
    from opencl_fft_tpu.utils.numerics import ilog2

    devices = jax.devices()[:ndev]
    if len(devices) < ndev:
        raise PhaseError(f"need {ndev} devices, found {len(devices)}")
    rng = np.random.default_rng(10)

    def run_sharded(cfg, mesh, irs, xs):
        state = sharded.sharded_pconv_init(cfg, irs.shape[0])
        shard = sharded.state_shardings(mesh)
        state = {k: jax.device_put(v, shard[k]) for k, v in state.items()}
        bsh = NamedSharding(mesh, PS("dp", None))
        state = sharded.sharded_push_ir(cfg, mesh, state,
                                        jax.device_put(jnp.asarray(irs), bsh))
        step = sharded.make_sharded_pconv_step(cfg, mesh, tv=False)
        t0 = time.perf_counter()
        state, o = step(state, jax.device_put(jnp.asarray(xs[0]), bsh))
        _block(o)
        first = time.perf_counter() - t0
        outs = [np.asarray(o)]
        ts = []
        for t in range(1, xs.shape[0]):
            t0 = time.perf_counter()
            state, o = step(state, jax.device_put(jnp.asarray(xs[t]), bsh))
            _block(o)
            ts.append(time.perf_counter() - t0)
            outs.append(np.asarray(o))
        return np.stack(outs), first, statistics.median(ts)

    # dp = ndev: channel-parallel serving
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    irs = np.stack([_ir(rng, ir_len) for _ in range(batch)]) * 0.2
    xs = (rng.standard_normal((nblocks, batch, pts)) * 0.1).astype(np.float32)
    got, first, per = run_sharded(cfg, make_mesh((ndev, 1), devices=devices),
                                  irs, xs)
    one = models.Convolver(cfg, batch)
    one.push_ir(irs)
    ref = np.asarray(one.stream(xs))
    rep.check("four", f"dp={ndev} serving {batch} ch @{ir_len} taps vs one "
              f"device", got, ref, 1e-5, first_call_s=first,
              us_per_step=per * 1e6,
              audio_s_per_s=batch * pts / SR / per)

    # tp = ndev: one long IR with its partitions spread over the devices
    lcfg = P.PconvConfig.for_ir_length(long_len, pts)
    lir = (rng.standard_normal((1, long_len)) * 0.01).astype(np.float32)
    lx = (rng.standard_normal((nblocks, 1, pts)) * 0.1).astype(np.float32)
    got, first, per = run_sharded(lcfg, make_mesh((1, ndev), devices=devices),
                                  lir, lx)
    st = P.push_ir(lcfg, P.pconv_init(lcfg), jnp.asarray(lir[0]))
    _, ref = jax.jit(lambda s, b: P.pconv_stream(lcfg, s, b))(
        st, jnp.asarray(lx[:, 0]))
    rep.check("four", f"tp={ndev} pconv step {long_len} taps @{pts} vs one "
              f"device", got[:, 0], np.asarray(ref), 1e-5,
              first_call_s=first, us_per_step=per * 1e6,
              rt_factor=(pts / SR) / per)

    # one 2^20-point transform sharded over the devices
    mesh = make_mesh((1, ndev), devices=devices)
    z = rng.standard_normal(fft_n) + 1j * rng.standard_normal(fft_n)
    sp = (jnp.asarray(z.real, jnp.float32), jnp.asarray(z.imag, jnp.float32))
    cs, ws, (re, im) = compile_and_time(
        lambda s: dist_fft_split(s, mesh, axis="tp"), sp, reps=reps)
    rep.check("four", f"dist_fft_split 2^{ilog2(fft_n)} over {ndev}",
              np.asarray(re) + 1j * np.asarray(im), np.fft.fft(z), 1e-4,
              compile_s=cs, warm_us=ws * 1e6)
    cs1, ws1, _ = compile_and_time(lambda s: fft_split(s, -1), sp, reps=reps)
    rep.note("four", f"one-device fft_split 2^{ilog2(fft_n)}",
             warm_us=ws1 * 1e6)


PHASES = (("fft", phase_fft), ("pconv", phase_pconv), ("tv", phase_tv),
          ("long-ir", phase_long_ir), ("serving", phase_serving),
          ("offline", phase_offline), ("pipeline", phase_pipeline),
          ("f64", phase_f64), ("determinism", phase_determinism))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    ap.add_argument("--out", default="", help="also write results as JSON")
    args = ap.parse_args(argv)

    from opencl_fft_tpu.utils.compile_cache import setup_compile_cache
    cache = setup_compile_cache()

    import jax

    devices = jax.devices()
    require_gpu(devices)
    for ln in smi_lines():
        print(f"nvidia-smi: {ln}", flush=True)
    print(f"jax {jax.__version__}: {devices[0].device_kind} x{len(devices)} "
          f"(platform {devices[0].platform}); compile cache {cache}",
          flush=True)

    rep = Report()
    phases = [("four", phase_four)] if args.four else PHASES
    t_all = time.perf_counter()
    for name, fn in phases:
        t0 = time.perf_counter()
        fn(rep)
        rep.note(name, "phase done", seconds=time.perf_counter() - t0,
                 peak_bytes_in_use=peak_bytes(devices[0]))
    total = time.perf_counter() - t_all
    print(f"total {total:.1f} s; failed: {rep.failed or 'none'}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(rows=rep.rows, failed=rep.failed, seconds=total),
                      f, indent=1)
    if rep.failed:
        return 1
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
