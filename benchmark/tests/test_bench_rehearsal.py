"""CPU rehearsals of every kind of cell at a tiny size: the whole run
(set-up, warm-up, window, traced window, the check against the plain
reference) on the program's plain twins.  A rehearsal reports no metric:
its times are the CPU's, not the card's."""
import pytest

from benchmark import run, spec
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("mix", tiny.MIXES)
def test_rehearsal_is_correct_and_reports_no_device_metric(root, mix, trace):
    cell = spec.load_cell(f"tiny.{mix}", root)
    result = run.run_cell(cell, 2**31 + 977, 0.2, bool(trace), "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"] == {}
    assert result["device"] == {"platform": "cpu", "count": 0}
    assert "breakdown" not in result
    assert list(result)[-1] == "checks"
    assert result["checks"]["max_rel_err"]["value"] < 2e-6
