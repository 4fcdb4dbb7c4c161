"""The metric arithmetic on hand-made timelines and counts, and the
frozen roofline copies against their origin in ``chip_smoke.py``."""
import math
import statistics

import numpy as np
import pytest
import torch

from benchmark import roofline, spec, timeline


def test_rate_runs_from_the_window_start_to_the_end_of_its_last_job():
    # three jobs of 2 units ending at 1.0, 2.5, 4.0 after a start at 0.5
    assert timeline.rate(6, 0.5, 4.0) == pytest.approx(6 / 3.5)


@pytest.mark.parametrize("n", [1, 2, 7, 20, 101])
def test_p95_is_numpys_linear_percentile(n):
    xs = list(np.random.default_rng(n).exponential(size=n))
    assert timeline.percentile(xs, 95) == pytest.approx(
        float(np.percentile(xs, 95)), rel=1e-12)


def test_busy_takes_the_union_of_overlapping_intervals():
    ivs = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    # inside [0, 10]: [0, 3] + [5, 6] + [9, 10]
    assert timeline.busy(ivs, 0.0, 10.0) == pytest.approx(5.0)
    assert timeline.gaps(ivs, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    idle_pct = spec.metric_reader("device.idle_pct")(
        {"device_events": len(ivs), "busy_s": 5.0, "window_s": 10.0})
    assert idle_pct == pytest.approx(50.0)


def test_idle_gaps_go_to_the_innermost_open_span():
    spans = [(0.0, 10.0, "bench.job"), (1.0, 4.0, "bench.build"),
             (5.0, 9.0, "bench.apply"), (12.0, 20.0, "bench.job")]
    gaps = [(0.2, 0.6), (2.0, 3.0), (10.0, 11.0), (15.0, 16.5)]
    assert dict(timeline.label_gaps(gaps, spans)) == pytest.approx(
        {"bench.job": 1.9, "bench.build": 1.0, "outside spans": 1.0})


def test_trace_keeps_the_programs_stages_as_host_spans(monkeypatch):
    """A profiled stretch on the CPU: the benchmark's ``bench.*`` ranges
    and the program's ``mmt.*`` stages come out as host spans, nested as
    they ran, and label the idle gaps; other host ops do not."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import profiling
    from multimesh_tpu_torch import utils_profile

    monkeypatch.setenv("MMT_PROFILE", "1")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            with record_function("bench.job"):
                with utils_profile.stage_timer("g2g.dedup"):
                    torch.ones(64).sum()
                with record_function("other"):
                    torch.ones(64).sum()
    dev, spans = profiling.trace_events(prof)
    assert dev == []
    names = [name for _, _, name in sorted(spans)]
    assert names == ["bench.window", "bench.job", "mmt.g2g.dedup"]
    (s, e, _), = [sp for sp in spans if sp[2] == "mmt.g2g.dedup"]
    mid = 0.5 * (s + e)
    assert timeline.label_gaps([(mid, mid)], spans) == [
        ("mmt.g2g.dedup", 0.0)]


def test_device_time_by_name():
    ev = [("k1", 0.0, 1.0), ("k2", 1.0, 1.5), ("k1", 2.0, 4.0)]
    assert timeline.by_name(ev) == [("k1", 3.0), ("k2", 0.5)]


def test_k1_and_k2_work_against_hand_sums():
    # order 4, 3-D: one evaluation of x and J per component is
    # 2*125 + 3*25 + 4*5 = 345 FMAs, of x alone 125 + 25 + 5 = 155
    flop, nbytes = roofline.newton_work(10, 3, 4, 3, 18)
    assert flop == 2 * 10 * 3 * (18 * 345 + 155)
    assert nbytes == 10 * (24 + 4 + 12 + 4) + 3 * (24 + 8 + 4 * 375)
    flop, nbytes = roofline.nearest_work(10, 7, 3)
    assert flop == 2 * 3 * 10 * 7
    assert nbytes == 10 * 28 + 7 * 24


def test_rooflines_stay_at_or_under_100_for_the_least_time():
    ctx = {"rows_located": 1_000_000, "distinct_elements": 4096,
           "source_elements": 4096, "order": 4, "dim": 3,
           "newton_iters": 18}
    flop, nbytes = roofline.newton_work(1_000_000, 4096, 4, 3, 18)
    least = max(flop / roofline.PEAK_F32, nbytes / roofline.PEAK_BYTES)
    k1 = spec.metric_reader("k1_newton_rows_roofline")
    assert k1({**ctx, "k1_device_s": least}) == pytest.approx(100.0)
    assert k1({**ctx, "k1_device_s": 4 * least}) == pytest.approx(25.0)
    assert k1({**ctx, "k1_device_s": 0.0}) is None
    flop, nbytes = roofline.nearest_work(1_000_000, 4096, 3)
    least = max(flop / roofline.PEAK_F32, nbytes / roofline.PEAK_BYTES)
    k2 = spec.metric_reader("k2_nearest_centroid_roofline")
    assert k2({**ctx, "k2_device_s": 2 * least}) == pytest.approx(50.0)
    assert k2({**ctx, "k2_device_s": 0.0}) is None


def test_per_job_and_per_row_readers():
    ctx = {"jobs": 4, "rows_located": 2_000_000, "retry_rows": 5000,
           "stages": {"g2g.dedup": 2.0, "g2g.stream_write": 0.4,
                      "operator.build": 0.3},
           "launches": {"newton_rows": 32, "nearest_centroid": 8}}
    read = spec.metric_reader
    assert read("engine.dedup_s_per_job")(ctx) == pytest.approx(0.5)
    assert read("engine.write_s_per_job")(ctx) == pytest.approx(0.1)
    assert read("transfer.build_s_per_mrow")(ctx) == pytest.approx(0.15)
    assert read("locate.k1_launches_per_mrow")(ctx) == pytest.approx(16.0)
    assert read("locate.retry_pct")(ctx) == pytest.approx(0.25)
    empty = {**ctx, "jobs": 0, "rows_located": 0, "stages": {}}
    for name in ("engine.dedup_s_per_job", "engine.write_s_per_job",
                 "transfer.build_s_per_mrow", "locate.k1_launches_per_mrow",
                 "locate.retry_pct"):
        assert read(name)(empty) is None


def test_quartile_spread_as_the_bounds_take_it():
    # the spread the bounds are set from: statistics.quantiles' quartiles
    xs = [1.0, 1.1, 1.2, 1.3, 1.4, 1.5]
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert (q3 - q1) / statistics.median(xs) == pytest.approx(
        0.35 / 1.25)


def test_frozen_roofline_copies_match_chip_smoke():
    chip_smoke = pytest.importorskip("chip_smoke")
    assert (roofline.PEAK_F32, roofline.PEAK_F64, roofline.PEAK_BYTES) == (
        chip_smoke.PEAK_F32, chip_smoke.PEAK_F64, chip_smoke.PEAK_BYTES)
    for order in range(1, 8):
        for dim in (2, 3):
            for jac in (False, True):
                assert roofline.sumfact_fmas(order, dim, jac) == \
                    chip_smoke.sumfact_fmas(order, dim, jac)
    for flop, nbytes in ((1e9, 1e6), (1e6, 1e9)):
        ms, by = chip_smoke.bound(flop, chip_smoke.PEAK_F32, nbytes)
        s, by2 = roofline.bound(flop, roofline.PEAK_F32, nbytes)
        assert (s * 1e3, by2) == (pytest.approx(ms), by)
    # newton_bound on tensors: 6 rows over elements {0, 2} of E = 4
    order, dim, iters, E, M = 4, 3, 18, 4, 6
    n_feat = (order + 1) ** dim * dim
    args = (torch.zeros(M, dim, dtype=torch.float64),
            torch.tensor([0, 2, 2, 0, 0, 2], dtype=torch.int32),
            torch.zeros(E, dim, dtype=torch.float64),
            torch.zeros(E, dtype=torch.float64),
            torch.zeros(E, n_feat, dtype=torch.float32),
            order, dim, iters, 8.0)
    refs = torch.zeros(M, dim, dtype=torch.float32)
    res = torch.zeros(M, dtype=torch.float32)
    ms, by = chip_smoke.newton_bound(args, refs, res)
    flop, nbytes = roofline.newton_work(M, 2, order, dim, iters)
    s, by2 = roofline.bound(flop, roofline.PEAK_F32, nbytes)
    assert (s * 1e3, by2) == (pytest.approx(ms), by)
    assert math.isfinite(s)
