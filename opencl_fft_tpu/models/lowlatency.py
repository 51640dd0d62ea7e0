"""Zero-added-latency convolution: non-uniform (Gardner) partitioning.

Beyond-parity capability. The reference's streaming convolution carries
one full partition of latency by construction (`csound/opcode.cpp:240-249`
reads the previous block's output), so low latency forces small
partitions and small partitions forfeit throughput — its own benchmark
sweeps that trade-off (`csound/tests.py:10`). The classic production
answer (Gardner 1995, "Efficient convolution without input-output
delay") removes the trade-off: split the impulse response into a direct
head that convolves in the time domain (no transform latency at all)
plus frequency-domain segments whose partition sizes DOUBLE with their
offset into the IR, so every segment's one-partition engine latency is
hidden behind the delay its taps already impose.

This module composes that scheme from the framework's existing engines —
the direct FIR delay line (`ops/dconv`, the Cldconv rebuild) for the
head and one `ops/pconv` engine (the Clpconv rebuild) per segment — into
a single functional streaming step with the defining property

    step t (given input blocks 0..t) emits  y[tB : (t+1)B]  exactly,

i.e. the streamed output equals offline ``scipy.signal.fftconvolve``
with NO added latency beyond the block granularity itself.

Scheduling invariants (asserted by ``plan_segments``):

* the head covers taps [0, B) at block size B;
* doubling segments cover [P, 2P) with partition size P for
  P = B, 2B, ... — offset == partition size, so each engine's
  one-partition latency exactly matches its tap offset (consumed with
  engine-block delay d = offset/pts = 1);
* once P reaches ``pmax`` the remaining taps run as ONE uniform engine
  at pts = pmax covering [pmax, ir_len); because the doubling phase
  maintains offset == pts throughout, the terminal segment also starts
  at offset == pmax, so EVERY segment (doubling or terminal) runs at
  consumption delay d = offset/pts == 1 — the tightest schedule the
  latency-hiding identity permits (the queue machinery handles any
  d >= 1, should a future planner relax the schedule).

Every engine fires on its own cadence (pts/B base blocks) inside a
``lax.cond`` — compiler-friendly control flow, no recompiles across
steps — and per-segment output queues of d+1 engine blocks realize the
consumption delays. All state is one pytree (checkpointable like every
other engine in the framework).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dconv as _d
from ..ops import pconv as _p
from ..utils.numerics import is_pow2

Float = jax.Array


@dataclasses.dataclass(frozen=True)
class Segment:
    """One frequency-domain segment of the non-uniform partition."""

    offset: int   # first tap covered (multiple of pts)
    pts: int      # partition size (multiple of the base block B)
    nparts: int   # partitions in this segment (1 during doubling)
    delay: int    # consumption delay in engine blocks == offset // pts

    @property
    def length(self) -> int:
        return self.pts * self.nparts


def plan_segments(ir_len: int, block: int, pmax: int = 1024
                  ) -> List[Segment]:
    """Non-uniform partition schedule for an ``ir_len``-tap response.

    Head [0, block) is implicit (direct engine). Returns [] when the IR
    fits entirely in the head.
    """
    if not is_pow2(block):
        raise ValueError(f"block must be a power of two, got {block}")
    if not is_pow2(pmax) or pmax < block:
        raise ValueError(f"pmax must be a power of two >= block, got {pmax}")
    segs: List[Segment] = []
    off = block
    pts = block
    while off < ir_len:
        if pts < pmax:
            segs.append(Segment(offset=off, pts=pts, nparts=1, delay=1))
            off += pts
            pts *= 2
        else:
            nparts = -(-(ir_len - off) // pmax)        # ceil
            segs.append(Segment(offset=off, pts=pmax, nparts=nparts,
                                delay=off // pmax))
            off += nparts * pmax
    # invariants the streaming step relies on
    cover = block
    for s in segs:
        assert s.offset == cover, (s, cover)
        assert s.offset % s.pts == 0 and s.delay == s.offset // s.pts
        assert s.delay >= 1
        cover += s.length
    assert cover >= ir_len
    return segs


class _SegState(NamedTuple):
    eng: _p.PconvState
    buf: Float     # (pts,) input accumulation for the current engine block
    queue: Float   # (delay + 1, pts) most recent engine outputs, oldest first


class ZLState(NamedTuple):
    """Whole-convolver streaming state (pytree; checkpointable)."""

    t: Float                        # () int32 base-block counter
    head: _d.DconvState
    segs: Tuple[_SegState, ...]


class ZeroLatencyConvolver:
    """Streaming convolution with no added latency (non-uniform scheme).

    >>> zl = ZeroLatencyConvolver(ir, block=64)
    >>> out = zl.process(in_block)          # (64,) -> (64,), zero latency

    ``block`` is the host I/O granularity; ``pmax`` caps the largest
    partition (throughput rises and per-step jitter falls with pmax, at
    no latency cost — the cap only bounds the terminal engine's
    transform size).
    """

    def __init__(self, ir, block: int = 64, pmax: int = 1024,
                 impl: str = "auto"):
        ir = np.asarray(ir, np.float32).reshape(-1)
        if ir.size < 1:
            raise ValueError("empty impulse response")
        self.ir_len = ir.size
        self.block = int(block)
        self.segments = plan_segments(ir.size, self.block, int(pmax))
        self._head_cfg = _d.DconvConfig(irsize=self.block, vsize=self.block)
        head_ir = np.zeros(self.block, np.float32)
        head_ir[: min(self.block, ir.size)] = ir[: self.block]
        head = _d.push_ir(self._head_cfg, _d.dconv_init(self._head_cfg),
                          head_ir)
        self._seg_cfgs = []
        seg_states = []
        for s in self.segments:
            cfg = _p.PconvConfig(pts=s.pts, nparts=s.nparts, impl=impl)
            self._seg_cfgs.append(cfg)
            seg_ir = np.zeros(cfg.cvs, np.float32)
            chunk = ir[s.offset: s.offset + s.length]
            seg_ir[: chunk.size] = chunk
            eng = _p.push_ir(cfg, _p.pconv_init(cfg), seg_ir)
            seg_states.append(_SegState(
                eng=eng,
                buf=jnp.zeros((s.pts,), jnp.float32),
                queue=jnp.zeros((s.delay + 1, s.pts), jnp.float32),
            ))
        self.state = ZLState(t=jnp.asarray(0, jnp.int32), head=head,
                             segs=tuple(seg_states))
        self._step = jax.jit(self._make_step())

    # -- functional core ---------------------------------------------------

    def _make_step(self):
        B = self.block
        head_cfg = self._head_cfg
        seg_cfgs = tuple(self._seg_cfgs)
        segments = tuple(self.segments)

        def step(state: ZLState, x: Float) -> Tuple[ZLState, Float]:
            t = state.t
            head, y = _d.dconv_step(head_cfg, state.head, x)
            new_segs = []
            for s, cfg, st in zip(segments, seg_cfgs, state.segs):
                r = s.pts // B
                m = t % r if r > 1 else jnp.zeros_like(t)
                # 1) accumulate this base block into the engine buffer
                buf = jax.lax.dynamic_update_slice(st.buf, x, (m * B,))
                # 2) consume: queue row 1 holds engine block t//r - delay
                #    (see scheduling invariants in the module docstring)
                y = y + jax.lax.dynamic_slice(st.queue[1], (m * B,), (B,))

                # 3) fire on the engine's cadence (m == r - 1)
                def run(eng_q, buf=buf, cfg=cfg, s=s):
                    eng, q = eng_q
                    eng, z = _p.pconv_step(cfg, eng, buf)
                    q = jnp.roll(q, -1, axis=0).at[s.delay].set(z)
                    return eng, q

                eng, queue = jax.lax.cond(
                    m == r - 1, run, lambda eq: eq, (st.eng, st.queue))
                new_segs.append(_SegState(eng=eng, buf=buf, queue=queue))
            return ZLState(t=t + 1, head=head,
                           segs=tuple(new_segs)), y

        return step

    # -- host surface -------------------------------------------------------

    def process(self, block) -> np.ndarray:
        """One base block in, one base block out — zero added latency."""
        x = jnp.asarray(np.asarray(block, np.float32).reshape(-1))
        if x.shape != (self.block,):
            raise ValueError(
                f"expected a ({self.block},) block, got {x.shape}")
        self.state, y = self._step(self.state, x)
        return np.asarray(y)

    def render(self, signal) -> np.ndarray:
        """Offline convenience: stream a whole signal (padded to blocks)
        through the zero-latency step via lax.scan; returns the full
        convolution tail included."""
        sig = np.asarray(signal, np.float32).reshape(-1)
        total = sig.size + self.ir_len - 1
        nblocks = -(-total // self.block)
        pad = np.zeros(nblocks * self.block, np.float32)
        pad[: sig.size] = sig
        blocks = jnp.asarray(pad.reshape(nblocks, self.block))
        step = self._step

        def body(st, blk):
            return step(st, blk)

        self.state, ys = jax.lax.scan(body, self.state, blocks)
        return np.asarray(ys).reshape(-1)[:total]

    def reset(self) -> None:
        """Zero the streaming state (keeps the analyzed IR spectra)."""
        self.state = ZLState(
            t=jnp.asarray(0, jnp.int32),
            head=self.state.head._replace(
                delay=jnp.zeros_like(self.state.head.delay),
                wp=jnp.asarray(0, jnp.int32)),
            segs=tuple(st._replace(
                eng=st.eng._replace(
                    spec_x_re=jnp.zeros_like(st.eng.spec_x_re),
                    spec_x_im=jnp.zeros_like(st.eng.spec_x_im),
                    tail=jnp.zeros_like(st.eng.tail),
                    wp=jnp.asarray(0, jnp.int32)),
                buf=jnp.zeros_like(st.buf),
                queue=jnp.zeros_like(st.queue)) for st in self.state.segs))
