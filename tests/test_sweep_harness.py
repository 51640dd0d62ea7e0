"""Sweep-harness logic tests (no device timing): the merge/median/repair
machinery that turns noisy per-point estimates into the published grid.

The measurement core (rt_ratio's on-device chains) is exercised on
hardware; here it is stubbed so the statistics are testable. Guards two
failure modes: clamped garbage ratios and max-keeping under run-to-run
spread."""

import json

import numpy as np
import pytest

from opencl_fft_tpu.bench import sweep as S


@pytest.fixture
def fake_points(monkeypatch):
    """Patch rt_ratio with a deterministic schedule of estimates."""
    calls = {}

    def install(schedule):
        # schedule: {(pts, L): [est0, est1, ...]} — consumed in order;
        # an entry of None raises Unmeasurable.
        def fake(pts, ir_len, scan_blocks=512, reps=4, tv=True):
            seq = schedule[(pts, ir_len)]
            i = calls.get((pts, ir_len), 0)
            calls[(pts, ir_len)] = i + 1
            v = seq[min(i, len(seq) - 1)]
            if v is None:
                raise S.Unmeasurable("stubbed")
            return v
        monkeypatch.setattr(S, "rt_ratio", fake)
        return calls
    return install


def test_median_combining_rejects_one_bad_window(fake_points, tmp_path):
    # L=2^16 point sees one drift-inflated estimate among three: the
    # median must discard it (max-keeping would have shipped 4000).
    sched = {(512, 1 << 16): [500.0, 4000.0, 520.0],
             (512, 1 << 17): [400.0, 410.0, 390.0]}
    fake_points(sched)
    out = str(tmp_path / "s")
    res = S.run_sweep([512], [1 << 16, 1 << 17], out_prefix=out,
                      row_repeats=3)
    assert res["M=512,L=2^16"] == 520.0
    assert res["M=512,L=2^17"] == 400.0


def test_unmeasurable_points_are_omitted_not_clamped(fake_points, tmp_path):
    sched = {(512, 1 << 16): [None, None, None],
             (512, 1 << 17): [300.0, 300.0, 300.0]}
    fake_points(sched)
    out = str(tmp_path / "s")
    res = S.run_sweep([512], [1 << 16, 1 << 17], out_prefix=out,
                      row_repeats=3)
    assert "M=512,L=2^16" not in res          # omitted loudly, not faked
    assert res["M=512,L=2^17"] == 300.0
    table = open(out + "_table.tex").read()
    assert "--" in table                      # gap is visible in the table


def test_monotonic_repair_remedians_both_endpoints(fake_points, tmp_path):
    # Two of the small-L point's three initial samples hit a slow window
    # (median 200, inverted vs 450 downstream); the repair adds estimates
    # to BOTH endpoints and re-medians until the inversion resolves.
    sched = {(512, 1 << 16): [200.0, 200.0, 500.0, 500.0, 500.0],
             (512, 1 << 17): [450.0, 450.0, 450.0, 450.0, 450.0]}
    calls = fake_points(sched)
    out = str(tmp_path / "s")
    res = S.run_sweep([512], [1 << 16, 1 << 17], out_prefix=out,
                      row_repeats=3)
    # both endpoints got extra estimates
    assert calls[(512, 1 << 16)] > 3
    assert calls[(512, 1 << 17)] > 3
    assert res["M=512,L=2^16"] >= res["M=512,L=2^17"] / 1.15
    # a point whose samples are CONSISTENTLY inverted is reported with a
    # warning, never force-ratcheted (median robustness cuts both ways)


def test_merge_preserves_other_rows_and_replaces_target(fake_points, tmp_path):
    prior = {"M=2048,L=2^16": 800.0, "M=512,L=2^16": 999.0}
    pj = tmp_path / "prior.json"
    pj.write_text(json.dumps(prior))
    sched = {(512, 1 << 16): [500.0, 500.0, 500.0]}
    fake_points(sched)
    out = str(tmp_path / "s")
    res = S.run_sweep([512], [1 << 16], out_prefix=out, row_repeats=3,
                      merge_json=str(pj))
    assert res["M=2048,L=2^16"] == 800.0      # untouched row survives
    assert res["M=512,L=2^16"] == 500.0       # stale entry replaced
    # artifacts cover the union of rows
    table = open(out + "_table.tex").read()
    assert "2048" in table and "512" in table


def test_median_chain_delta_zero_floor_rejects_nonpositive():
    """With floor 0 (what bench.py and the sweep pass) only non-positive
    deltas are rejected: a real reading of any size survives, a chain
    whose long run is not slower than its short run never does."""
    from opencl_fft_tpu.utils.profiling import median_chain_delta

    d, n = median_chain_delta(lambda k: 1e-7 * k, 4, 0.0)
    assert n == 3 and abs(d - 1e-7) < 1e-12
    d, n = median_chain_delta(lambda k: 0.010, 4, 0.0)
    assert d is None and n == 0


def test_merge_falls_back_to_prior_on_unmeasurable(fake_points, tmp_path):
    """A re-measured point that never clears the floor must keep the
    prior artifact value (with a stderr note), not delete data."""
    prior = {"M=512,L=2^16": 777.0}
    pj = tmp_path / "prior.json"
    pj.write_text(json.dumps(prior))
    sched = {(512, 1 << 16): [None, None, None]}
    fake_points(sched)
    out = str(tmp_path / "s")
    res = S.run_sweep([512], [1 << 16], out_prefix=out, row_repeats=3,
                      merge_json=str(pj))
    assert res["M=512,L=2^16"] == 777.0


def test_median_chain_delta_contract():
    """The shared estimator: floor-guarded, median-combined, and honest
    about windows that never produce >= 2 physical deltas."""
    from opencl_fft_tpu.utils.profiling import median_chain_delta

    # deterministic fake clock: chain of n calls takes n*10ms + jitter
    seq = iter([0.010, 0.010, 0.050, 0.050,     # delta = 10ms
                0.012, 0.011, 0.049, 0.048,     # delta ~ 9.25ms
                0.010, 0.010, 0.054, 0.052])    # delta = 10.5ms
    d, n = median_chain_delta(lambda k: next(seq), 4, 1e-3)
    assert n == 3 and 8e-3 < d < 11e-3

    # every delta below the floor -> (None, 0), never a clamped value
    d, n = median_chain_delta(lambda k: 0.010, 4, 1e-3)
    assert d is None and n == 0


def test_median_chain_delta_min_chain_span():
    """min_chain_s grows reps until the long-minus-short span carries the
    target device-work duration (a chain spanning a few ms publishes host
    sync jitter as signal), without consuming sample tries, and capped at
    max_reps_scale."""
    from opencl_fft_tpu.utils.profiling import median_chain_delta

    calls = []

    def timed(k):                       # exact 1 ms per chained call
        calls.append(k)
        return 1e-3 * k

    d, n = median_chain_delta(timed, 4, 1e-5, min_chain_s=0.05)
    assert n == 3 and abs(d - 1e-3) < 1e-9
    # the accepted samples ran on grown chains spanning >= 50 ms
    assert max(calls) - 1 >= 50, calls

    # growth is capped: a target no chain can reach still returns the
    # honest per-call delta from the capped chain
    calls.clear()
    d, n = median_chain_delta(timed, 2, 1e-9, min_chain_s=10.0,
                              max_reps_scale=8)
    assert n >= 2 and abs(d - 1e-3) < 1e-9
    assert max(calls) - 1 <= 16, calls
