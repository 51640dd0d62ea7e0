"""Real-time host pipeline: audio thread <-> device worker over SPSC rings.

The reference's opcode layer lives inside a real-time engine: the audio
callback (``aperf``) both feeds the convolver and emits its output in the
same thread, accepting one partition of latency (opcode.cpp:229-252). On
an accelerator the dispatch and host<->device copy latency must never
block the audio callback, so the rebuild decouples the two with
the lock-free SPSC rings of the native runtime (runtime/stream_rt.cpp):

    audio thread --push--> [in ring(s)] --> device worker --> [out ring]
                                                              --pull--> audio thread

The worker drains full ``pts``-sample blocks from the input ring(s), runs
one jitted engine step on device, and writes the result to the output
ring. ``prime_blocks`` partitions of silence are pre-queued on the output
ring so the audio thread has a latency budget of
``(prime_blocks * pts) / sr`` seconds — as long as the device sustains
real time, the consumer never underruns, and the emitted stream equals the
offline render delayed by exactly the priming.

Underruns (consumer asked for samples the worker hadn't produced) and
overruns (producer pushed faster than the worker drained) are counted, not
hidden — they are the real-time health metrics. A worker-thread failure is
likewise surfaced, not hidden: the exception is recorded and re-raised
from the next ``push``/``pull``/``wait_for_blocks`` (and at context exit),
so a dead pipeline can never silently deadlock its consumer.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from . import NativeRingBuffer, native_available


class _PipelineBase:
    """Ring + worker-thread scaffolding shared by the pipelines below.

    Owns: the single-stream input ring, the primed output ring, the worker
    thread lifecycle, the underrun/overrun/progress counters, and the
    worker-failure surface. A subclass defines the per-block unit of work
    (``_work_once``) and may add input rings / override ``push``.
    """

    def __init__(self, block: int, prime_blocks: int, capacity_blocks: int):
        if not native_available():
            raise RuntimeError("native runtime unavailable (no toolchain)")
        self.block = int(block)
        self._capacity = capacity_blocks * self.block
        self._in_x = NativeRingBuffer(self._capacity)
        self._out = NativeRingBuffer(self._capacity
                                     + max(prime_blocks, 1) * self.block)
        # priming: the one-partition-latency budget of the opcode layer
        # (opcode.cpp:240-249), generalized to prime_blocks blocks
        if prime_blocks:
            self._out.write(np.zeros(prime_blocks * self.block, np.float32))
        self.prime_blocks = prime_blocks
        self.underrun_samples = 0
        self.overrun_samples = 0
        self.blocks_processed = 0
        self.error: Optional[BaseException] = None
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- worker ------------------------------------------------------------

    def _work_once(self) -> bool:
        """Process one block if available; True if work was done."""
        raise NotImplementedError

    def _worker(self):
        try:
            while not self._stop_evt.is_set():
                if not self._work_once():
                    time.sleep(50e-6)
            while self._work_once():          # drain what's already queued
                pass
        except Exception as e:                # surfaced by _check_error()
            self.error = e

    def _check_error(self) -> None:
        if self.error is not None:
            raise RuntimeError(
                f"pipeline worker died: {self.error!r}") from self.error

    def start(self):
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._stop_evt.set()
            self._thread.join()
            self._thread = None

    def wait_for_blocks(self, n: int = 1, timeout: float = 30.0) -> None:
        """Block until the worker has processed >= n blocks (e.g. to warm
        the jit outside a paced loop). Raises if the worker died or the
        timeout expires — never hangs on a dead pipeline."""
        deadline = time.monotonic() + timeout
        while self.blocks_processed < n:
            self._check_error()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"pipeline processed {self.blocks_processed}/{n} blocks "
                    f"within {timeout}s")
            time.sleep(1e-3)

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, *exc):
        self.stop()
        if exc_type is None:      # don't mask an in-flight exception
            self._check_error()

    # -- audio-thread surface (real-time safe: ring ops only) --------------

    def push(self, x: np.ndarray) -> int:
        """Producer side. Returns samples accepted; short writes are
        counted as overruns (the worker is not keeping up)."""
        self._check_error()
        x = np.ascontiguousarray(x, np.float32)
        n = self._in_x.write(x)
        self.overrun_samples += x.size - n
        return n

    def pull(self, n: int) -> np.ndarray:
        """Consumer side: always returns n samples; missing samples are
        zeros and counted as underruns (what a sound card would hear)."""
        self._check_error()
        got = self._out.read(n)
        if got.size < n:
            self.underrun_samples += n - got.size
            got = np.concatenate([got, np.zeros(n - got.size, np.float32)])
        return got

    def pull_available(self) -> int:
        return self._out.available()


class RealtimePipeline(_PipelineBase):
    """Streaming convolution engine behind lock-free rings.

    Parameters
    ----------
    cfg : ops.pconv.PconvConfig — engine configuration.
    ir : optional (cvs,) float32 — impulse response (LTI mode). When None
        and ``tv=True`` the pipeline runs time-varying convolution and
        expects two input streams per push.
    prime_blocks : output-latency budget in partitions (>= 1).
    capacity_blocks : ring capacity in partitions.
    """

    def __init__(self, cfg, ir: Optional[np.ndarray] = None,
                 tv: bool = False, prime_blocks: int = 2,
                 capacity_blocks: int = 64):
        if prime_blocks < 1:
            raise ValueError("prime_blocks must be >= 1")
        super().__init__(cfg.pts, prime_blocks, capacity_blocks)
        import jax
        from functools import partial
        from ..ops import pconv as P

        self.cfg = cfg
        self.pts = cfg.pts
        self.tv = tv
        self._in_h = NativeRingBuffer(self._capacity) if tv else None
        self._state = P.pconv_init(cfg)
        if ir is not None:
            self._state = P.push_ir(cfg, self._state, ir)
        if tv:
            self._step = jax.jit(partial(P.pconv_step_tv, cfg),
                                 donate_argnums=(0,))
        else:
            self._step = jax.jit(partial(P.pconv_step, cfg),
                                 donate_argnums=(0,))

    def _work_once(self) -> bool:
        pts = self.pts
        if self._in_x.available() < pts:
            return False
        if self.tv and self._in_h.available() < pts:
            return False
        if self._out.space() < pts:
            return False                      # backpressure: let consumer drain
        bx = self._in_x.read(pts)
        if self.tv:
            bh = self._in_h.read(pts)
            self._state, out = self._step(self._state, bx, bh)
        else:
            self._state, out = self._step(self._state, bx)
        self._out.write(np.asarray(out, np.float32))
        self.blocks_processed += 1
        return True

    def push(self, x: np.ndarray, h: Optional[np.ndarray] = None) -> int:
        if not self.tv:
            return super().push(x)
        self._check_error()
        x = np.ascontiguousarray(x, np.float32)
        if h is None or len(h) != len(x):
            raise ValueError("tv pipeline needs matching x and h blocks")
        n = min(self._in_x.space(), self._in_h.space(), x.size)
        self._in_x.write(x[:n])
        self._in_h.write(np.ascontiguousarray(h[:n], np.float32))
        self.overrun_samples += x.size - n
        return n


class ProcessorPipeline(_PipelineBase):
    """RealtimePipeline for any block processor (the opcode-layer
    surface): wraps an object with ``process(block) -> block`` — e.g.
    ``ClconvProcessor`` (including ``parts=0``, the zero-added-latency
    engine) or ``CltvconvProcessor`` via a lambda — behind the same
    native SPSC rings and device worker thread.

    ``prime_blocks`` may be 0: with the zero-latency engine the emitted
    stream then equals the offline convolution with NO algorithmic
    offset — the only latency left is scheduling (the consumer must
    tolerate the worker's compute time, or budget prime_blocks >= 1).
    """

    def __init__(self, processor, block_size: int,
                 prime_blocks: int = 1, capacity_blocks: int = 64):
        if prime_blocks < 0:
            raise ValueError("prime_blocks must be >= 0")
        # fixed-block processors (direct / zero-latency engines) reject
        # other sizes inside the worker thread — fail at construction
        # instead of as a dead worker
        pbs = getattr(processor, "block_size", None)
        if pbs is not None and int(pbs) != int(block_size):
            raise ValueError(
                f"processor is fixed at {int(pbs)}-sample blocks; "
                f"pipeline block_size={int(block_size)} cannot feed it")
        super().__init__(block_size, prime_blocks, capacity_blocks)
        self._proc = processor
        self.block_size = self.block

    def _work_once(self) -> bool:
        bs = self.block
        if self._in_x.available() < bs or self._out.space() < bs:
            return False
        out = self._proc.process(self._in_x.read(bs))
        self._out.write(np.ascontiguousarray(out, np.float32))
        self.blocks_processed += 1
        return True
