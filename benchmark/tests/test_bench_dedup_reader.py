"""The reader of the engine's dedup counters on hand-made stage totals
and counters: the card's share against a hand sum, None where the engine
did not run, 0 where it ran and no dedup counter did."""
import pytest

from benchmark import spec
from multimesh_tpu_torch import utils_profile


def test_dedup_card_pct(monkeypatch):
    held = {}
    monkeypatch.setattr(utils_profile, "counter_totals", lambda: dict(held))
    read = spec.metric_reader("engine.dedup_card_pct")
    ctx = {"jobs": 4, "rows_located": 0, "stages": {"g2g.fingerprint": 0.1}}
    held.update({"dedup.card_rows": 3_000_000, "dedup.host_rows": 1_000_000})
    assert read(ctx) == pytest.approx(75.0)
    held["dedup.host_rows"] = 0
    assert read(ctx) == 100.0
    held.clear()
    assert read(ctx) == 0.0
    assert read({**ctx, "stages": {"locate.round1": 0.02}}) is None
