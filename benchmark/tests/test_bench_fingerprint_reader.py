"""The reader of the engine's fingerprint counters on hand-made stage
totals and counters: the card's share against a hand sum, None where the
engine did not run or where neither counter did (a program without
them)."""
import pytest

from benchmark import spec
from multimesh_tpu_torch import utils_profile


def test_fingerprint_card_pct(monkeypatch):
    held = {}
    monkeypatch.setattr(utils_profile, "counter_totals", lambda: dict(held))
    read = spec.metric_reader("engine.fingerprint_card_pct")
    ctx = {"jobs": 4, "rows_located": 0, "stages": {"g2g.fingerprint": 0.1}}
    held.update({"fingerprint.card_bytes": 3 * 16384,
                 "fingerprint.host_bytes": 16384})
    assert read(ctx) == pytest.approx(75.0)
    held["fingerprint.host_bytes"] = 0
    assert read(ctx) == 100.0
    held.update({"fingerprint.card_bytes": 0,
                 "fingerprint.host_bytes": 16384})
    assert read(ctx) == 0.0
    held.clear()
    assert read(ctx) is None
    held["fingerprint.frozen_hits"] = 4
    assert read(ctx) is None
    held["fingerprint.card_bytes"] = 16384
    assert read({**ctx, "stages": {"locate.round1": 0.02}}) is None
