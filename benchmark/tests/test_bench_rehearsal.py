"""CPU rehearsals of every kind of cell at a tiny size: the whole run
(set-up, warm-up, window, traced window, the check against the plain
reference) on the program's plain twins.  A rehearsal reports no metric:
its times are the CPU's, not the card's."""
import pytest
import torch

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


@pytest.mark.parametrize("mix", ["points_1m", "mesh_new_1m"])
def test_the_probe_counts_the_distinct_elements_it_counted_before(
        root, mix, monkeypatch):
    """``program_probe`` keeps a mask of each operator's elements, not the
    elements: the count K1's roofline reads is the one that the unique
    elements of each traced operator gave."""
    import os

    from multimesh_tpu_torch import TransferOperator

    monkeypatch.delenv("MMT_PROFILE", raising=False)
    original = TransferOperator.__dict__["build"]
    traced = []  # the elements of each operator built under the probe

    def build(cls, *args, **kwargs):
        op = original.__func__(cls, *args, **kwargs)
        if os.environ.get("MMT_PROFILE") == "1":
            traced.append(op.elements.clone())
        return op

    monkeypatch.setattr(TransferOperator, "build", classmethod(build))
    contexts = []
    per_layer = run._per_layer

    def spy(*args):
        ctx, breakdown = per_layer(*args)
        contexts.append(ctx)
        return ctx, breakdown

    monkeypatch.setattr(run, "_per_layer", spy)
    cell = spec.load_cell(f"tiny.{mix}", root)
    result = run.run_cell(cell, 2**31 + 1201, 0.2, True, "cpu")
    assert result["correct"], result["checks"]
    assert traced and len(contexts) == 1
    assert contexts[0]["distinct_elements"] == sum(
        int(torch.unique(el[el >= 0]).numel()) for el in traced)
