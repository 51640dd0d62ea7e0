"""Distributed serving demo: a multi-channel convolution farm sharded
over a device mesh (dp x tp) with the `parallel.sharded` engines.

The reference scales by running one OpenCL context per device and
hand-placing opcode instances (csound/opcode.cpp constructs a context
per instance; csound/tests.py sweeps --device to bench each one). The
answer here is a sharding, not a device loop: ONE jitted step over
a `jax.sharding.Mesh`, channels split across the data-parallel axis and
each channel's partition ring split across the tensor-parallel axis,
with XLA inserting the single O(pts) psum per block the tp contraction
needs (pinned by tests/test_parallel.py::test_tp_collective_structure).

Runs on whatever devices exist: N real chips, or the virtual CPU mesh
(run via tests/conftest or XLA_FLAGS=--xla_force_host_platform_device_count=8
with JAX_PLATFORMS forced to cpu in-process). One real chip -> (1, 1)
mesh (the sharded program is still the one that scales).

Run:  python examples/dist_serving_demo.py [channels] [blocks]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SR = 48000.0


def run(channels: int = 8, nblocks: int = 32, pts: int = 128,
        nparts: int = 16, verbose: bool = True) -> float:
    """Stream `nblocks` blocks through the sharded farm; cross-check one
    channel against the single-device engine; return the max abs error."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P_

    from opencl_fft_tpu.ops import pconv as P
    from opencl_fft_tpu.parallel import sharded
    from opencl_fft_tpu.parallel.mesh import balanced_shape, make_mesh

    ndev = len(jax.devices())
    dp, tp = balanced_shape(ndev)
    # dp must divide channels, tp must divide nparts; shrinking either
    # strands devices, so build the mesh on the first dp*tp of them
    while dp > 1 and channels % dp:
        dp //= 2
    while tp > 1 and nparts % tp:
        tp //= 2
    mesh = make_mesh((dp, tp), devices=jax.devices()[:dp * tp])
    if verbose:
        print(f"devices: {ndev} ({jax.devices()[0].platform}), "
              f"mesh dp={dp} x tp={tp}, channels={channels}, "
              f"ring {nparts} x {pts}")

    cfg = P.PconvConfig.for_ir_length(pts * nparts, pts)
    rng = np.random.default_rng(0)
    irs = (rng.standard_normal((channels, cfg.cvs)) * 0.2).astype(np.float32)

    sh = sharded.state_shardings(mesh)
    state = {k: jax.device_put(v, sh[k])
             for k, v in sharded.sharded_pconv_init(cfg, channels).items()}
    ir_dev = jax.device_put(jnp.asarray(irs),
                            NamedSharding(mesh, P_("dp", None)))
    state = sharded.sharded_push_ir(cfg, mesh, state, ir_dev)
    step = sharded.make_sharded_pconv_step(cfg, mesh, tv=False)

    blocks = (rng.standard_normal((nblocks, channels, pts)) * 0.1
              ).astype(np.float32)
    outs = []
    t0 = time.time()
    for b in range(nblocks):
        state, out = step(state, jnp.asarray(blocks[b]))
        outs.append(np.asarray(out))
    elapsed = time.time() - t0
    outs = np.stack(outs)                       # (nblocks, channels, pts)

    # oracle: channel 0 on the plain single-device engine
    st0 = P.push_ir(cfg, P.pconv_init(cfg), jnp.asarray(irs[0]))
    _, ref = P.pconv_stream(cfg, st0, jnp.asarray(blocks[:, 0]))
    err = float(np.max(np.abs(outs[:, 0] - np.asarray(ref))))
    scale = float(np.max(np.abs(np.asarray(ref)))) or 1.0

    if verbose:
        audio_s = nblocks * pts / SR * channels
        print(f"streamed {nblocks} blocks x {channels} ch in "
              f"{elapsed:.2f}s ({audio_s / elapsed:.1f} audio-s/s "
              f"aggregate; eager per-block dispatch — see bench.py for "
              f"honest device timings)")
        print(f"channel-0 vs single-device engine: max err {err:.2e} "
              f"(scale {scale:.2e}) -> "
              f"{'PASS' if err <= 3e-5 * max(1.0, scale) else 'FAIL'}")
    return err / max(1.0, scale)


def main():
    channels = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    nblocks = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    rel = run(channels, nblocks)
    if rel > 3e-5:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
