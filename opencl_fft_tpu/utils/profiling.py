"""Profiling / tracing helpers.

The reference has none (queues created without CL_QUEUE_PROFILING_ENABLE,
SURVEY §5.1); external wall-clock timing only. Here:

  * ``trace(path)`` — context manager around jax.profiler for device traces
    viewable in TensorBoard/XProf.
  * ``median_chain_delta`` / ``device_timer`` — per-call time as the delta
    between a long and a short on-device chain (lax.fori_loop), which
    cancels dispatch and host-sync cost.
  * FLOP conventions used by the benchmarks (5 N log2 N per FFT — the
    BASELINE.json convention).
"""

from __future__ import annotations

import contextlib
import time
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


@contextlib.contextmanager
def trace(path: str):
    """Capture a device trace of the enclosed block into directory `path`."""
    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()


def fft_flops(n: int, batch: int = 1) -> float:
    """5 N log2 N convention (BASELINE.json:2)."""
    return 5.0 * n * np.log2(n) * batch


def pconv_flops_per_block(pts: int, nparts: int) -> float:
    """Two rFFTs (~half-size complex) + 8-flop complex MAC per partition bin."""
    return 2 * fft_flops(pts) + 8.0 * nparts * pts


def _force(x) -> float:
    """Wait for the device and copy one value to the host."""
    leaf = jax.tree.leaves(x)[0]
    return float(jnp.sum(leaf[..., :1]))


def median_chain_delta(timed: Callable[[int], float], reps: int,
                       floor: float, *, short: int = 1, samples: int = 3,
                       min_samples: int = 2, tries: int = 5,
                       pair: int = 2, min_chain_s: float = 0.0,
                       max_reps_scale: int = 256):
    """Median of floor-guarded long-minus-short chain deltas (used by
    bench.py and bench/sweep.py).

    Each delta is (timed(short+reps) - timed(short)) / reps with short
    and long each min-of-`pair`, so per-dispatch and host-sync cost
    cancels. Deltas at or below `floor` (0 rejects only non-positive
    readings) are discarded and the chain doubled; the estimate is the
    median of up to `samples` surviving deltas.

    ``min_chain_s``: minimum long-minus-short span the chain must carry.
    Each host reading has some sync jitter that the delta divides by
    `reps`; a chain spanning only a few ms of device work would publish
    that jitter as signal. A valid delta whose span is below the target
    grows `reps` toward it and is retried (not counted as a sample, but
    consuming a try); growth is capped at `max_reps_scale`x the starting
    reps so a mis-estimated target cannot run away.

    Returns (delta_seconds_per_call, n_valid). n_valid below
    `min_samples` means at most one delta survived — callers must treat
    it as unmeasurable and omit, never clamp.
    """
    deltas = []
    reps_cap = reps * max_reps_scale
    grows = 0
    t = 0
    while t < tries:
        t_short = min(timed(short) for _ in range(pair))
        t_long = min(timed(short + reps) for _ in range(pair))
        span = t_long - t_short
        d = span / reps
        if d <= floor:
            reps = min(reps * 2, reps_cap)   # longer chain, retry
            t += 1
            continue
        if span < min_chain_s and reps < reps_cap and grows < 8:
            # valid but too short to out-divide sync jitter:
            # grow toward the target span (own budget, not a failed try)
            grow = int(np.ceil(min_chain_s / max(span, min_chain_s / 16)))
            reps = min(reps * max(grow, 2), reps_cap)
            grows += 1
            continue
        deltas.append(d)
        t += 1
        if len(deltas) >= samples:
            break
    n = len(deltas)
    if n < min_samples:
        return None, n
    return float(np.median(deltas)), n


def device_timer(step: Callable, x0, iters: int = 20) -> float:
    """Seconds per application of `step`, amortizing launch+sync overhead.

    step: x -> x (same pytree structure, so it can chain on device).
    """
    @partial(jax.jit, static_argnums=1)
    def run(x, n):
        return jax.lax.fori_loop(0, n, lambda i, x: step(x), x)

    _force(run(x0, 1))
    _force(run(x0, iters))
    t0 = time.time(); _force(run(x0, 1)); t1 = time.time() - t0
    t0 = time.time(); _force(run(x0, iters)); tn = time.time() - t0
    return max(tn - t1, 1e-12) / (iters - 1)
