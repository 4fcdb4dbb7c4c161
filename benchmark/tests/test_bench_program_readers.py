"""The readers of the program's ladder, grid and engine spans and
counters on hand-made stage totals and counters: each number against a
hand sum, None where its layer did not run (the marker stage missing, as
on a program without these spans), and 0 where the layer ran and its own
stage or counter is missing."""
import pytest

from benchmark import spec
from multimesh_tpu_torch import utils_profile

MROWS = 2_000_000
LADDER = {"locate.round1": 0.02, "locate.rounds23": 0.06,
          "locate.round4": 0.02, "operator.build": 0.12}


def _ctx(stages, rows=MROWS, jobs=4):
    return {"jobs": jobs, "rows_located": rows, "stages": dict(stages)}


@pytest.fixture
def counters(monkeypatch):
    """Sets what ``utils_profile.counter_totals()`` returns."""
    held = {}
    monkeypatch.setattr(utils_profile, "counter_totals", lambda: dict(held))
    return held


def test_round1_seconds_per_mrow():
    read = spec.metric_reader("locate.round1_s_per_mrow")
    assert read(_ctx(LADDER)) == pytest.approx(0.01)
    assert read(_ctx({"operator.build": 0.1})) is None
    assert read(_ctx(LADDER, rows=0)) is None


def test_rescue_seconds_per_mrow():
    read = spec.metric_reader("locate.rescue_s_per_mrow")
    assert read(_ctx(LADDER)) == pytest.approx(0.04)
    assert read(_ctx({"locate.round1": 0.02})) == 0.0
    assert read(_ctx({"locate.round1": 0.02, "locate.round4": 0.01})) \
        == pytest.approx(0.005)
    assert read(_ctx({"operator.build": 0.1})) is None


def test_k1_rows_per_mrow(counters):
    read = spec.metric_reader("locate.k1_rows_per_mrow")
    counters.update({"k1.rows": 4_160_000, "ladder.round1.rows": MROWS})
    assert read(_ctx(LADDER)) == pytest.approx(2_080_000)
    counters.clear()
    assert read(_ctx(LADDER)) == 0.0
    assert read(_ctx({"g2g.fingerprint": 0.1})) is None


def test_round1_miss_pct(counters):
    read = spec.metric_reader("locate.round1_miss_pct")
    counters.update({"ladder.round1.rows": 524_288,
                     "ladder.round1.missed": 1042})
    assert read(_ctx(LADDER)) == pytest.approx(100 * 1042 / 524_288)
    counters["ladder.round1.missed"] = 0
    assert read(_ctx(LADDER)) == 0.0
    counters.clear()
    assert read(_ctx(LADDER)) == 0.0
    assert read(_ctx({})) is None


def test_grid_search_seconds_per_mrow():
    read = spec.metric_reader("grid.search_s_per_mrow")
    stages = {**LADDER, "grid.probe_bins": 0.09, "grid.rank_members": 0.03}
    assert read(_ctx(stages)) == pytest.approx(0.06)
    assert read(_ctx(LADDER)) == 0.0  # the K2 route: no grid search
    assert read(_ctx({"grid.probe_bins": 0.09})) is None


def test_fingerprint_seconds_per_job():
    read = spec.metric_reader("engine.fingerprint_s_per_job")
    assert read(_ctx({"g2g.fingerprint": 0.14})) == pytest.approx(0.035)
    assert read(_ctx(LADDER)) is None
    assert read(_ctx({"g2g.fingerprint": 0.14}, jobs=0)) is None


def test_load_seconds_per_job():
    read = spec.metric_reader("engine.load_s_per_job")
    stages = {"g2g.fingerprint": 0.14, "g2g.load_operator": 0.044}
    assert read(_ctx(stages)) == pytest.approx(0.011)
    assert read(_ctx({"g2g.fingerprint": 0.14})) == 0.0  # nothing stored
    assert read(_ctx(LADDER)) is None
