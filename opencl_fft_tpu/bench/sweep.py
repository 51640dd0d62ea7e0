"""Benchmark sweep harness — the analog of the reference's csound/tests.py.

The reference times `cltvconv` against the CPU `tvconv` for 100 s of audio
across devices x partition sizes M in {2^9, 2^11, 2^13, 2^15} x IR lengths
L in {2^16..2^22}, then writes a real-time-ratio plot and a LaTeX table
(csound/tests.py:10-76). This module reproduces that sweep for this
library's engines:

  * the workload is the time-varying partitioned convolver (the same
    engine `cltvconv` drives);
  * the metric is the real-time ratio dur/elapsed (tests.py:33);
  * outputs: sweep.json (all points), table.tex (the table.tex analog,
    tests.py:70-76) and plot.csv — RT ratio vs log2(L) per partition size
    (matplotlib is optional; the CSV always works).

Run:  python -m opencl_fft_tpu.bench.sweep [--quick]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial

import numpy as np

SR = 44100.0          # the reference benches at sr=44100 (tests.csd:3)


def _sync(x):
    import jax
    import jax.numpy as jnp
    return float(jnp.sum(jax.tree.leaves(x)[0][..., :1]))


class Unmeasurable(RuntimeError):
    """No usable timing delta at this point even after retries; the point
    is OMITTED rather than shipped (never a clamped value)."""


def rt_ratio(pts: int, ir_len: int, scan_blocks: int = 512, reps: int = 4,
             tv: bool = True) -> float:
    """Real-time ratio of the (tv-)partitioned convolver at one sweep point."""
    import jax
    import jax.numpy as jnp
    from ..ops import pconv as P
    from ..utils.profiling import median_chain_delta

    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    rng = np.random.default_rng(0)
    base = jax.tree.map(np.asarray, P.pconv_init(cfg))

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

    # Repetition chained ON DEVICE (fori_loop): one dispatch per timed
    # chain. The summed-output carry stops XLA dead-code-eliminating
    # compute that feeds only the output. The state uploads ONCE and each
    # timed call takes a device-side copy completed before the clock
    # starts.
    @partial(jax.jit, static_argnums=1, donate_argnums=0)
    def run_k(st, k):
        def body(i, carry):
            st, acc = carry
            st2, out = step(st, *args)
            return st2, acc + jnp.sum(out)
        return jax.lax.fori_loop(0, k, body, (st, jnp.float32(0.0)))

    base_dev = jax.block_until_ready(make_state())

    @jax.jit
    def fresh(s):                             # device-side copy, no donation
        return jax.tree.map(lambda a: a * 1, s)

    def timed(k):
        st = jax.block_until_ready(fresh(base_dev))
        t0 = time.perf_counter()
        jax.block_until_ready(run_k(st, k)[1])
        return time.perf_counter() - t0

    timed(1)                                  # compile both trip counts
    timed(1 + reps)
    # long-minus-short chain deltas (utils.profiling.median_chain_delta);
    # reps grow until a chain spans >= 50 ms
    delta, n = median_chain_delta(timed, reps, 0.0, tries=4,
                                  min_chain_s=0.05)
    if delta is None:
        raise Unmeasurable(
            f"M={pts} L={ir_len}: only {n} positive delta(s) after retries")
    per_block = delta / scan_blocks
    return (pts / SR) / per_block


def cpu_rt_ratio_inprocess(pts: int, ir_len: int, scan_blocks: int = 32,
                           repeats: int = 3, tv: bool = True) -> float:
    """Real-time ratio of the SAME workload on the CPU backend — the
    comparison-oracle arm of the reference's benchmark (its published
    table is GPU vs the CPU `tvconv` opcode on the identical signal
    path, /root/reference/csound/tests.py:19-34, tests.csd:14-18).

    Must run in a process whose jax platform is cpu BEFORE backend init
    (measure_cpu_oracle provisions one). Plain wall-clock timing, min
    over repeats."""
    import jax
    import jax.numpy as jnp

    from ..ops import pconv as P

    cfg = P.PconvConfig.for_ir_length(ir_len, pts)
    rng = np.random.default_rng(0)
    base = jax.tree.map(np.asarray, P.pconv_init(cfg))
    blocks = jnp.asarray(rng.standard_normal((scan_blocks, pts)) * 0.1,
                         jnp.float32)
    if tv:
        fn = jax.jit(partial(P.pconv_stream_tv, cfg), donate_argnums=(0,))
        args = (blocks, blocks)
    else:
        fn = jax.jit(partial(P.pconv_stream, cfg), donate_argnums=(0,))
        args = (blocks,)

    def make_state():
        return jax.tree.map(jnp.asarray, base)

    _sync(fn(make_state(), *args)[1])           # compile + warm
    best = float("inf")
    for _ in range(repeats):
        st = make_state()
        t0 = time.time()
        st, out = fn(st, *args)
        _sync(out)
        best = min(best, time.time() - t0)
    per_block = best / scan_blocks
    return (pts / SR) / per_block


def measure_cpu_oracle(parts_list, ir_list, out_path, tv=True,
                       timeout_s=1200):
    """CPU-backend timings for every grid point, via one subprocess per
    point (the parent's jax runs on the GPU; the child forces cpu before
    backend init and never touches the card). Results merge into
    `out_path` (points already present are kept)."""
    import os
    import subprocess

    try:
        with open(out_path) as f:
            cpu = json.load(f)
    except (OSError, json.JSONDecodeError):
        cpu = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    site = os.path.dirname(os.path.dirname(np.__file__))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root, site] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    for pts in parts_list:
        for L in ir_list:
            if L < pts:
                continue
            key = f"M={pts},L=2^{int(np.log2(L))}"
            if key in cpu:
                continue
            code = (
                "import jax; jax.config.update('jax_platforms','cpu');\n"
                "from opencl_fft_tpu.bench.sweep import "
                "cpu_rt_ratio_inprocess as f;\n"
                f"print('CPU_RT', f({pts}, {L}, tv={tv}))")
            try:
                r = subprocess.run([sys.executable, "-c", code],
                                   capture_output=True, text=True,
                                   timeout=timeout_s, env=env)
                line = [ln for ln in (r.stdout or "").splitlines()
                        if ln.startswith("CPU_RT ")]
                if r.returncode == 0 and line:
                    cpu[key] = round(float(line[0].split()[1]), 1)
                    print(f"  cpu-oracle {key}: {cpu[key]:.1f}x realtime",
                          file=sys.stderr, flush=True)
                else:
                    print(f"  cpu-oracle {key}: FAILED "
                          f"({(r.stderr or '')[-160:]})",
                          file=sys.stderr, flush=True)
            except subprocess.TimeoutExpired:
                print(f"  cpu-oracle {key}: timeout after {timeout_s}s",
                      file=sys.stderr, flush=True)
            with open(out_path, "w") as f:
                json.dump(cpu, f, indent=2)
    return cpu


_HISTORY_KEEP = 9      # pooled drift windows per published point


def _code_fingerprint() -> str:
    """Hash of the dispatch-relevant modules (everything under ops/,
    which holds the engines, kernels and measured dispatch tables).
    History windows are stamped with this; a window measured under a
    different program is auto-discarded instead of silently pooling
    stale-kernel readings into shipped numbers (the failure mode was:
    re-running after a kernel change without the documented
    --reset-history blended old-program windows into the medians)."""
    import hashlib
    import os

    from .. import ops
    root = os.path.dirname(os.path.abspath(ops.__file__))
    h = hashlib.sha256()
    for dirpath, _dirs, files in sorted(os.walk(root)):
        if "__pycache__" in dirpath:
            continue
        for fn in sorted(files):
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn), "rb") as f:
                    h.update(fn.encode())
                    h.update(f.read())
    return h.hexdigest()[:16]


def _load_history(hist_path: str, fp: str) -> dict:
    """history file -> {key: [windows]}, dropping stale-fingerprint
    entries AND legacy un-stamped lists. (r5 initially grandfathered the
    legacy format; a --repeats 0 artifact regen then re-stamped those
    stale-methodology windows with the current fingerprint, silently
    pooling them into fresh measurements — exactly the laundering the
    stamp exists to prevent. Unstamped windows are now discarded.)"""
    try:
        with open(hist_path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    out = {}
    stale = []
    for k, v in raw.items():
        if isinstance(v, dict) and v.get("fp") == fp:
            out[k] = v.get("windows", [])
        else:
            stale.append(k)
    if stale:
        print(f"  history: discarded {len(stale)} stale-fingerprint "
              f"point(s) (code changed since they were measured): "
              f"{', '.join(sorted(stale)[:6])}"
              f"{'...' if len(stale) > 6 else ''}",
              file=sys.stderr, flush=True)
    return out


def run_sweep(parts_list, ir_list, tv=True, out_prefix="sweep",
              row_repeats=2, merge_json=None, reset_history=False):
    """Measure the grid. Each M-row is swept row_repeats times end-to-end;
    each point's published value is the MEDIAN of its pooled window
    estimates, then the row is checked for monotonicity: RT
    ratio must be non-increasing in L (longer IR, strictly more work per
    block). Inversions get extra estimates on both endpoints and a
    re-median; survivors are reported to stderr rather than silently
    shipped.

    Cross-RUN window pooling: per-window estimates persist in
    `<out_prefix>_history.json` and each re-run APPENDS its estimates,
    publishing the median of the last _HISTORY_KEEP windows, so one bad
    run cannot set a published point. reset_history=True (--reset-history) clears the measured rows'
    history first — REQUIRED after a code change that alters those
    rows' kernels (stale windows describe the old program).

    merge_json: path to a prior sweep.json — its points seed the result
    table so a single re-measured row (--row) refreshes the full-grid
    artifacts without re-running every point. Re-measured points REPLACE
    the stale entries; a point that comes back Unmeasurable in every
    pass falls back to its prior value (kept, with a stderr note) rather
    than leaving a hole where data existed."""
    results = {}
    prior_row = {}
    if merge_json:
        with open(merge_json) as f:
            results.update(json.load(f))
        for pts in parts_list:                 # stale row: fully replace
            for L in ir_list:
                if L < pts:
                    continue      # mirror the Ls filter below: a prior
                    # point outside the measured set must not be popped
                    # (it would never be re-added -> silent data loss)
                old = results.pop(f"M={pts},L=2^{int(np.log2(L))}", None)
                if old is not None:
                    prior_row[(pts, L)] = old
    hist_path = f"{out_prefix}_history.json"
    fp = _code_fingerprint()
    history = _load_history(hist_path, fp)
    for pts in parts_list:
        Ls = [L for L in ir_list if L >= pts]
        if reset_history:
            for L in Ls:
                history.pop(f"M={pts},L=2^{int(np.log2(L))}", None)
        est = {L: [] for L in Ls}              # this run's estimates
        broken = set()                         # compile-failed points
        for _ in range(row_repeats):           # whole-row passes: one bad
            for L in Ls:                       # pass cannot poison a point
                if L in broken:
                    continue
                try:
                    est[L].append(rt_ratio(pts, L, tv=tv))
                except Unmeasurable:
                    continue                 # other repeats cover the point
                except Exception as e:       # e.g. out of memory — one
                    broken.add(L)            # bad point must not kill the
                    print(f"  M={pts} L=2^{int(np.log2(L))}: FAILED "
                          f"({str(e)[:160]})", file=sys.stderr, flush=True)
                    continue                 # row's artifacts (r3 crash)
        def pooled(L):
            key = f"M={pts},L=2^{int(np.log2(L))}"
            return (history.get(key, []) + est[L])[-_HISTORY_KEEP:]

        row = {L: float(np.median(pooled(L))) for L, v in est.items() if v}
        for L in Ls:
            if est[L]:
                print(f"  M={pts} L=2^{int(np.log2(L))}: run estimates "
                      f"{[round(v, 1) for v in est[L]]}, pooled "
                      f"{[round(v, 1) for v in pooled(L)]}",
                      file=sys.stderr, flush=True)
        # monotonicity repair: an out-of-order point means one window
        # still dominates its median — add estimates, re-median
        for _ in range(2):
            bad = set()                        # either side may be off
            for i in range(len(Ls) - 1):
                if (Ls[i] in row and Ls[i + 1] in row
                        and row[Ls[i + 1]] > row[Ls[i]] * 1.15):
                    bad.update((Ls[i], Ls[i + 1]))
            if not bad:
                break
            for L in sorted(bad):
                if L in broken:
                    continue
                try:
                    est[L].append(rt_ratio(pts, L, tv=tv))
                except Unmeasurable:
                    continue
                except Exception:
                    broken.add(L)
                    continue
                row[L] = float(np.median(pooled(L)))
        for i in range(len(Ls) - 1):
            if (Ls[i] in row and Ls[i + 1] in row
                    and row[Ls[i + 1]] > row[Ls[i]] * 1.15):
                print(f"  WARNING: M={pts} row non-monotone at "
                      f"L=2^{int(np.log2(Ls[i]))} after re-measures",
                      file=sys.stderr, flush=True)
        for L in Ls:
            if L not in row:
                if L in broken:
                    # deterministic failure (compile error), NOT a timing
                    # glitch: re-shipping the prior value would advertise
                    # throughput for a config that cannot currently run
                    print(f"  M={pts} L=2^{int(np.log2(L))}: DROPPED "
                          f"(point fails to compile/run; prior value NOT "
                          f"carried over)", file=sys.stderr, flush=True)
                    continue
                if (pts, L) in prior_row:      # keep prior data over a hole
                    row[L] = prior_row[(pts, L)]
                    print(f"  M={pts} L=2^{int(np.log2(L))}: unmeasurable "
                          f"this run — KEPT prior value "
                          f"{row[L]:.1f}x", file=sys.stderr, flush=True)
                else:
                    print(f"  M={pts} L=2^{int(np.log2(L))}: unmeasurable",
                          file=sys.stderr, flush=True)
                    continue
            results[f"M={pts},L=2^{int(np.log2(L))}"] = round(row[L], 1)
            print(f"  M={pts:6d} L=2^{int(np.log2(L)):2d}: "
                  f"{row[L]:10.1f}x realtime", file=sys.stderr, flush=True)
        for L in Ls:                           # persist this run's windows
            if est[L]:
                key = f"M={pts},L=2^{int(np.log2(L))}"
                history[key] = [round(v, 1) for v in pooled(L)]

    with open(hist_path, "w") as f:
        json.dump({k: {"fp": fp, "windows": v} for k, v in history.items()},
                  f, indent=2)
    with open(f"{out_prefix}.json", "w") as f:
        json.dump(results, f, indent=2)

    # artifacts cover every point in the (possibly merged) result table
    all_parts = sorted({int(k.split(",")[0][2:]) for k in results})
    all_irs = sorted({1 << int(k.split("=2^")[1]) for k in results})
    parts_list = sorted(set(parts_list) | set(all_parts))
    ir_list = sorted(set(ir_list) | set(all_irs))

    # table.tex analog (tests.py:70-76): rows = partition sizes, cols = L.
    # When the CPU-oracle arm has been measured (--cpu-oracle ->
    # <prefix>_cpu.json), each M additionally gets a CPU row and a
    # device/CPU speedup row — the reference's published table is exactly
    # this device-vs-`tvconv` comparison (tests.csd:14-18).
    try:
        with open(f"{out_prefix}_cpu.json") as f:
            cpu = json.load(f)
    except (OSError, json.JSONDecodeError):
        cpu = {}
    with open(f"{out_prefix}_table.tex", "w") as f:
        cols = " & ".join(f"$2^{{{int(np.log2(L))}}}$" for L in ir_list)
        f.write("\\begin{tabular}{l" + "r" * len(ir_list) + "}\n")
        f.write(f"M / L & {cols} \\\\\n\\hline\n")
        for pts in parts_list:
            vals, cvals, rvals = [], [], []
            for L in ir_list:
                key = f"M={pts},L=2^{int(np.log2(L))}"
                vals.append(f"{results[key]:.0f}" if key in results else "--")
                cvals.append(f"{cpu[key]:.0f}" if key in cpu else "--")
                rvals.append(f"{results[key] / cpu[key]:.1f}"
                             if key in results and cpu.get(key) else "--")
            f.write(f"{pts} & " + " & ".join(vals) + " \\\\\n")
            if any(v != "--" for v in cvals):
                f.write(f"{pts} (cpu) & " + " & ".join(cvals) + " \\\\\n")
                f.write(f"{pts} (speedup) & " + " & ".join(rvals)
                        + " \\\\\n")
        f.write("\\end{tabular}\n")

    # plot.csv: RT ratio vs log2(L), one column per M (plot.eps analog)
    with open(f"{out_prefix}_plot.csv", "w") as f:
        f.write("log2L," + ",".join(f"M{p}" for p in parts_list) + "\n")
        for L in ir_list:
            row = [str(int(np.log2(L)))]
            for pts in parts_list:
                key = f"M={pts},L=2^{int(np.log2(L))}"
                row.append(str(results.get(key, "")))
            f.write(",".join(row) + "\n")

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        for pts in parts_list:
            xs, ys = [], []
            for L in ir_list:
                key = f"M={pts},L=2^{int(np.log2(L))}"
                if key in results:
                    xs.append(int(np.log2(L)))
                    ys.append(results[key])
            ax.plot(xs, ys, marker="o", label=f"M={pts}")
        ax.set_xlabel("log2(IR length)")
        ax.set_ylabel("x real time")
        ax.set_yscale("log")
        ax.legend()
        fig.savefig(f"{out_prefix}_plot.png", dpi=120)
    except Exception:
        pass                                        # CSV is the durable output

    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small sweep (CI-sized)")
    ap.add_argument("--lti", action="store_true",
                    help="bench the LTI engine instead of time-varying")
    ap.add_argument("--row", type=int, default=0,
                    help="re-measure ONE partition-size row only")
    ap.add_argument("--merge", default="",
                    help="prior sweep.json to seed un-re-measured points")
    ap.add_argument("--out", default="sweep", help="artifact path prefix")
    ap.add_argument("--repeats", type=int, default=3,
                    help="end-to-end row sweeps (median kept per point)")
    ap.add_argument("--reset-history", action="store_true",
                    help="clear the measured rows' pooled window history "
                         "first (REQUIRED after a code change that alters "
                         "those rows' kernels)")
    ap.add_argument("--cpu-oracle", action="store_true",
                    help="also measure the CPU-backend comparison arm "
                         "(one subprocess per missing grid point; merged "
                         "into <out>_cpu.json and the table.tex "
                         "speedup rows)")
    args = ap.parse_args()
    from ..utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    if args.row:
        parts = [args.row]
        irs = [1 << k for k in range(16, 23)]
    elif args.quick:
        parts = [1 << 9, 1 << 11]
        irs = [1 << 16, 1 << 18]
    else:
        # the reference grid: tests.py:10,12
        parts = [1 << 9, 1 << 11, 1 << 13, 1 << 15]
        irs = [1 << k for k in range(16, 23)]
    if args.cpu_oracle:
        measure_cpu_oracle(parts, irs, f"{args.out}_cpu.json",
                           tv=not args.lti)
    run_sweep(parts, irs, tv=not args.lti, out_prefix=args.out,
              row_repeats=args.repeats, merge_json=args.merge or None,
              reset_history=args.reset_history)


if __name__ == "__main__":
    main()
