"""Benchmark driver — prints ONE JSON line on stdout.

Headline metric (the reference's own benchmark, csound/tests.py:19-34): the
real-time factor of streaming partitioned convolution — seconds of audio
processed per second of wall clock — with a 2^17-tap IR at 48 kHz streamed
in 512-sample partitions (the M=512 row of the reference's sweep, its most
latency-demanding configuration). BASELINE.json target: > 100x real time.

Secondary metrics (batched FFT GFLOP/s sweep 2^10..2^20, direct-conv and
TV-conv throughput) go to stderr and bench_details.json.

Methodology: every timed region chains its work on the device in a
fori_loop, and a call's time is the delta between a long and a short
chain (utils.profiling.median_chain_delta), which cancels dispatch and
host-sync cost. Every result names the device it ran on; the benchmark
refuses to run without a GPU.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import numpy as np

SR = 48000.0


class Unmeasurable(RuntimeError):
    """Fewer than two positive chain deltas: the metric is OMITTED
    (loudly) rather than published."""


def _time_chained_fori(step, make_state, args, reps=3):
    """Seconds per step() call, with the repetition chained ON DEVICE in
    a fori_loop — ONE dispatch per timed chain.

    step: raw callable (state, *args) -> (state, out). The output is
    folded into a checksum carried through the loop so XLA cannot
    dead-code-eliminate the compute that only feeds `out` (e.g. the
    dconv FIR dot, whose state update alone would keep none of it).
    Static trip counts: reps stays FIXED per compile; the estimator
    grows it until a chain spans >= 50 ms of device work.

    The base state uploads to the device ONCE and every timed call gets
    a fresh device-side copy, completed before the clock starts.
    """
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.utils.profiling import median_chain_delta

    @partial(jax.jit, static_argnums=1, donate_argnums=0)
    def run_k(st, k):
        def body(i, carry):
            st, acc = carry
            st2, out = step(st, *args)
            return st2, acc + jnp.sum(out)
        return jax.lax.fori_loop(0, k, body,
                                 (st, jnp.float32(0.0)))

    base = jax.block_until_ready(jax.tree.map(jnp.asarray, make_state()))

    @jax.jit
    def fresh(s):                             # device-side copy, no donation
        return jax.tree.map(lambda a: a * 1, s)

    def timed(k):
        st = jax.block_until_ready(fresh(base))
        t0 = time.perf_counter()
        jax.block_until_ready(run_k(st, k)[1])
        return time.perf_counter() - t0

    timed(1)                                   # compile both trip counts
    timed(1 + reps)
    dt, n = median_chain_delta(timed, reps, 0.0, min_chain_s=0.05)
    if dt is None:
        raise Unmeasurable(f"only {n} positive timing delta(s)")
    return dt


def bench_pconv_rt(pts=512, ir_len=1 << 17, tv=False, scan_blocks=1880):
    """Real-time factor of the streaming engine."""
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.ops import pconv as P

    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    rng = np.random.default_rng(0)
    ir = jnp.asarray(rng.standard_normal(ir_len), jnp.float32)
    base = jax.tree.map(np.asarray, P.push_ir(cfg, P.pconv_init(cfg), ir))

    def make_state():
        return jax.tree.map(jnp.asarray, base)

    blocks = jnp.asarray(rng.standard_normal((scan_blocks, pts)) * 0.1,
                         jnp.float32)
    if tv:
        step = partial(P.pconv_stream_tv, cfg)
        args = (blocks, blocks)
    else:
        step = partial(P.pconv_stream, cfg)
        args = (blocks,)

    per_scan = _time_chained_fori(step, make_state, args, reps=16)
    per_block = per_scan / scan_blocks
    return (pts / SR) / per_block, per_block


def bench_dconv(irsize=512, vsize=512, scan_blocks=1880):
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.ops import dconv as D

    cfg = D.DconvConfig(irsize=irsize, vsize=vsize)
    rng = np.random.default_rng(2)
    base = jax.tree.map(
        np.asarray,
        D.push_ir(cfg, D.dconv_init(cfg),
                  jnp.asarray(rng.standard_normal(irsize), jnp.float32)))

    def make_state():
        return jax.tree.map(jnp.asarray, base)

    blocks = jnp.asarray(rng.standard_normal((scan_blocks, vsize)) * 0.1,
                         jnp.float32)
    per_scan = _time_chained_fori(partial(D.dconv_stream, cfg), make_state,
                                  (blocks,), reps=16)
    per_block = per_scan / scan_blocks
    return (vsize / SR) / per_block


def bench_pconv_chunk(pts=512, ir_len=1 << 17, K=8, scan_blocks=1880,
                      ring_dtype="f32"):
    """Chunked streaming (K blocks per fused call, K-block latency)."""
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.ops import pconv as P

    cfg = P.PconvConfig.for_ir_length(ir_len, pts, ring_dtype=ring_dtype)
    rng = np.random.default_rng(0)
    ir = jnp.asarray(rng.standard_normal(ir_len), jnp.float32)
    base = jax.tree.map(np.asarray, P.push_ir(cfg, P.pconv_init(cfg), ir))

    def make_state():
        return jax.tree.map(jnp.asarray, base)

    blocks = jnp.asarray(
        rng.standard_normal((scan_blocks // K, K, pts)) * 0.1, jnp.float32)

    def chunked(st, chunks):
        return jax.lax.scan(lambda s, c: P.pconv_chunk(cfg, s, c), st, chunks)

    nblocks = blocks.shape[0] * K
    per_scan = _time_chained_fori(chunked, make_state, (blocks,), reps=16)
    per_block = per_scan / nblocks
    return (pts / SR) / per_block


def bench_pconv_offline(pts=512, ir_len=1 << 17, scan_blocks=1880):
    """Offline render throughput (batched transforms + gather-MAC, no
    sequential scan; latency = render length)."""
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.ops import pconv as P

    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    rng = np.random.default_rng(0)
    ir = jnp.asarray(rng.standard_normal(ir_len), jnp.float32)
    base = jax.tree.map(np.asarray, P.push_ir(cfg, P.pconv_init(cfg), ir))

    def make_state():
        return jax.tree.map(jnp.asarray, base)

    blocks = jnp.asarray(rng.standard_normal((scan_blocks, pts)) * 0.1,
                         jnp.float32)
    per_scan = _time_chained_fori(partial(P.pconv_offline, cfg), make_state,
                                  (blocks,), reps=16)
    per_block = per_scan / scan_blocks
    return (pts / SR) / per_block


def bench_serving_offline(batch=16, pts=512, ir_len=1 << 17, scan_blocks=470):
    """Offline serving throughput: `batch` channels rendered through the
    batched offline engine (ops/pconv._offline_batched). Aggregate
    audio-s/s."""
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.models.convolver import batched_state, _vmapped_push
    from opencl_fft_tpu.ops import pconv as P

    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    rng = np.random.default_rng(3)
    irs = jnp.asarray(rng.standard_normal((batch, ir_len)) * 0.05, jnp.float32)
    st0 = jax.jit(_vmapped_push(cfg))(batched_state(cfg, batch), irs)
    base = jax.tree.map(np.asarray, st0)

    def make_state():
        return jax.tree.map(jnp.asarray, base)

    blocks = jnp.asarray(rng.standard_normal((scan_blocks, batch, pts)) * 0.1,
                         jnp.float32)
    per_scan = _time_chained_fori(partial(P._offline_batched, cfg),
                                  make_state, (blocks,), reps=8)
    per_block = per_scan / scan_blocks
    return batch * (pts / SR) / per_block


def bench_batched_serving(batch=64, pts=512, ir_len=1 << 17, scan_blocks=470,
                          ring_dtype="f32"):
    """Serving throughput: `batch` independent channels convolving against
    their own 2^17-tap IRs. Returns aggregate audio-seconds per wall second
    (channels x per-channel RT factor).

    ring_dtype="bf16" trades ~1e-3 relative output error for halved
    ring bytes (products still accumulate in f32)."""
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.models.convolver import batched_state, _vmapped_push
    from opencl_fft_tpu.ops import pconv as P

    cfg = P.PconvConfig.for_ir_length(ir_len, pts, ring_dtype=ring_dtype)
    rng = np.random.default_rng(3)
    irs = jnp.asarray(rng.standard_normal((batch, ir_len)) * 0.05, jnp.float32)
    st0 = jax.jit(_vmapped_push(cfg))(batched_state(cfg, batch), irs)
    base = jax.tree.map(np.asarray, st0)

    def make_state():
        return jax.tree.map(jnp.asarray, base)

    blocks = jnp.asarray(rng.standard_normal((scan_blocks, batch, pts)) * 0.1,
                         jnp.float32)
    per_scan = _time_chained_fori(partial(P.pconv_stream_batched, cfg),
                                  make_state, (blocks,), reps=3)
    per_block = per_scan / scan_blocks
    return batch * (pts / SR) / per_block


def bench_batched_serving_chunked(batch=64, pts=512, ir_len=1 << 17, K=8,
                                  scan_blocks=472):
    """Latency-relaxed serving throughput: K-block chunked streaming of
    `batch` channels (matches per-block streaming within f32 tolerance,
    at the price of K blocks of added latency — 85 ms at K=8, pts=512,
    48 kHz).

    Why it exists: the one-block-latency batched stream must re-read all
    channels' h spectra plus an nparts-deep ring window every block
    (batch=64, 2^17 taps: ~134 MB/block f32). Chunking K blocks through
    the scan-free offline engine reads them once per chunk, the serving
    operating point whenever the deployment tolerates a few dozen ms of
    latency."""
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.models.convolver import _vmapped_push, batched_state
    from opencl_fft_tpu.ops import pconv as P

    assert scan_blocks % K == 0
    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    rng = np.random.default_rng(3)
    irs = jnp.asarray(rng.standard_normal((batch, ir_len)) * 0.05, jnp.float32)
    st0 = jax.jit(_vmapped_push(cfg))(batched_state(cfg, batch), irs)
    base = jax.tree.map(np.asarray, st0)

    def make_state():
        return jax.tree.map(jnp.asarray, base)

    blocks = jnp.asarray(
        rng.standard_normal((scan_blocks, batch, pts)) * 0.1, jnp.float32)
    per_scan = _time_chained_fori(
        partial(P.pconv_stream_batched_chunked, cfg, K=K), make_state,
        (blocks,), reps=3)
    per_block = per_scan / scan_blocks
    return batch * (pts / SR) / per_block


def bench_fft_sweep(passes=3, sizes=(10, 12, 14, 16, 18, 20)):
    """Batched FFT GFLOP/s (5 N log2 N convention), 2^10..2^20.

    The whole size loop runs `passes` times and each size publishes the
    MEDIAN across its per-pass medians, with the spread alongside."""
    import jax
    import jax.numpy as jnp
    from opencl_fft_tpu.ops.fft import fft_split
    from opencl_fft_tpu.utils.profiling import median_chain_delta

    rng = np.random.default_rng(1)
    runners = {}
    for logn in sizes:
        n = 1 << logn
        batch = max(1, (32 << 20) // (8 * n))      # ~32MB working set
        re = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)
        im = jnp.asarray(rng.standard_normal((batch, n)), jnp.float32)

        @partial(jax.jit, static_argnums=1)
        def run(x, iters, n=n):
            def body(i, x):
                # the chain normalization rides the fused scale
                return fft_split(x, -1, "auto", scale=1.0 / np.sqrt(n))
            return jax.lax.fori_loop(0, iters, body, x)

        iters = 200
        jax.block_until_ready(run((re, im), 1))
        jax.block_until_ready(run((re, im), iters))

        def timed(k, run=run, re=re, im=im):
            t0 = time.perf_counter()
            jax.block_until_ready(run((re, im), k))
            return time.perf_counter() - t0

        runners[logn] = (timed, batch, iters)

    samples = {logn: [] for logn in runners}
    for p in range(passes):
        for logn, (timed, batch, iters) in runners.items():
            dt, _nv = median_chain_delta(timed, iters - 1, 0.0)
            if dt is not None:
                samples[logn].append(dt)

    results = {}
    for logn, (timed, batch, iters) in runners.items():
        n = 1 << logn
        ds = sorted(samples[logn])
        if not ds:
            print(f"  fft 2^{logn}: unmeasurable in all {passes} passes, "
                  f"omitted", file=sys.stderr)
            continue
        dt = ds[(len(ds) - 1) // 2]
        gf = lambda d: 5 * n * logn * batch / d / 1e9
        results[f"2^{logn}"] = {
            "batch": batch, "us": round(dt * 1e6, 1),
            "gflops": round(gf(dt), 1),
            "gflops_spread": {"min": round(gf(ds[-1]), 1),
                              "median": round(gf(dt), 1),
                              "max": round(gf(ds[0]), 1),
                              "passes": len(ds)},
        }
        print(f"  fft 2^{logn} batch={batch}: {dt*1e6:9.1f} us "
              f"{gf(dt):8.1f} GFLOP/s (spread {gf(ds[-1]):.0f}/"
              f"{gf(dt):.0f}/{gf(ds[0]):.0f} over {len(ds)})",
              file=sys.stderr)
    return results


def _measure_multiwindow(details, metrics, passes=3):
    """Measure every secondary metric `passes` times, ROUND-ROBIN,
    publishing each metric's MEDIAN with the full min/median/max spread
    alongside. Round-robin puts paired comparisons (bf16 vs f32 rings,
    chunked vs plain) side by side in every pass.

    metrics: {key: (fn, fmt)}. Omits LOUDLY when all passes fail."""
    samples = {k: [] for k in metrics}
    for p in range(passes):
        for key, (fn, _fmt) in metrics.items():
            t0 = time.time()
            try:
                samples[key].append(fn())
                print(f"  pass {p} {key}: {samples[key][-1]:.1f} "
                      f"({time.time() - t0:.0f}s)", file=sys.stderr,
                      flush=True)
            except Unmeasurable as e:
                print(f"  pass {p} {key}: {e}", file=sys.stderr, flush=True)
            except Exception as e:
                print(f"  pass {p} {key}: FAILED ({str(e)[:160]})",
                      file=sys.stderr, flush=True)
    for key, (_fn, fmt) in metrics.items():
        vals = sorted(samples[key])
        if not vals:
            print(f"OMITTED {key}: unmeasurable in all {passes} passes",
                  file=sys.stderr)
            continue
        med = vals[(len(vals) - 1) // 2]
        details[key] = round(med, 1)
        details[key + "_spread"] = {
            "min": round(vals[0], 1), "median": round(med, 1),
            "max": round(vals[-1], 1), "passes": len(vals)}
        print(fmt.format(med)
              + f" (spread {vals[0]:.0f}/{med:.0f}/{vals[-1]:.0f} "
              f"over {len(vals)} passes)", file=sys.stderr)


def device_info() -> dict:
    """platform / device_kind / count of the devices measured on; exits
    unless they are GPUs (a CPU number is never published as a device
    metric)."""
    import jax

    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu":
        raise SystemExit(f"bench.py: no GPU found ({info})")
    return info


def main():
    from opencl_fft_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    device = device_info()
    print(f"device: {device}", file=sys.stderr)
    details = {"device": device}

    # three full estimates; the headline is the MEDIAN, with the full
    # min/median/max spread alongside
    attempts = []
    for attempt in range(3):
        try:
            attempts.append(bench_pconv_rt())
        except Unmeasurable as e:
            print(f"headline attempt {attempt}: {e}", file=sys.stderr)
    if not attempts:
        raise SystemExit("headline metric unmeasurable after 3 attempts")
    attempts.sort(key=lambda t: t[0])
    # lower-middle on even counts: publishing attempts[1] of 2 would be
    # the max
    rtf, per_block = attempts[(len(attempts) - 1) // 2]
    details["pconv_rt_factor_2^17_512"] = round(rtf, 1)
    details["pconv_us_per_block"] = round(per_block * 1e6, 1)
    details["pconv_rt_factor_spread"] = {
        "min": round(attempts[0][0], 1),
        "median": round(rtf, 1),
        "max": round(attempts[-1][0], 1),
        "passes": len(attempts),
    }
    print(f"pconv 2^17-tap @512: {rtf:.1f}x real time "
          f"({per_block*1e6:.0f} us/block; spread "
          f"{attempts[0][0]:.0f}/{rtf:.0f}/"
          f"{attempts[-1][0]:.0f}x over {len(attempts)} passes)",
          file=sys.stderr)

    _measure_multiwindow(details, {
        "tvconv_rt_factor_2^17_512": (
            lambda: bench_pconv_rt(tv=True)[0],
            "tvconv 2^17-tap @512: {:.1f}x real time"),
        "dconv_rt_factor_512tap": (
            bench_dconv, "dconv 512-tap: {:.1f}x real time"),
        "serving_64ch_audio_seconds_per_second": (
            bench_batched_serving,
            "serving 64ch 2^17-tap: {:.0f} aggregate audio-s/s"),
        "serving_64ch_bf16_audio_seconds_per_second": (
            lambda: bench_batched_serving(ring_dtype="bf16"),
            "serving 64ch bf16 rings (~1e-3 err): {:.0f} "
            "aggregate audio-s/s"),
        "serving_64ch_chunk8_audio_seconds_per_second": (
            bench_batched_serving_chunked,
            "serving 64ch chunked K=8 (85 ms latency): {:.0f} "
            "aggregate audio-s/s"),
        "pconv_offline_rt_factor": (
            bench_pconv_offline, "pconv offline render: {:.0f}x real time"),
        "serving_offline_16ch_audio_seconds_per_second": (
            bench_serving_offline,
            "serving-offline 16ch: {:.0f} aggregate audio-s/s"),
        "pconv_chunk8_rt_factor": (
            bench_pconv_chunk, "pconv chunked K=8: {:.1f}x real time"),
        "pconv_chunk8_bf16_rt_factor": (
            lambda: bench_pconv_chunk(ring_dtype="bf16"),
            "pconv chunked K=8 bf16: {:.1f}x real time"),
    })

    details["fft_sweep"] = bench_fft_sweep()

    with open("bench_details.json", "w") as f:
        json.dump(details, f, indent=2)

    # Headline line (target: >100x real time, BASELINE.json)
    print(json.dumps({
        "metric": "pconv_realtime_factor_2^17tap_512pts",
        "value": round(rtf, 1),
        "unit": "x_realtime",
        "vs_baseline": round(rtf / 100.0, 2),
        "device": device,
    }))


if __name__ == "__main__":
    main()
