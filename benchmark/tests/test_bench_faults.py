"""The check sees a broken program: a whole run with the timed path
broken underneath ends with ``correct`` false, once for each fault a cell
can have.  (The cells run on one card: there is no exchange between
chips to leave out.)"""
import pytest
import torch

from benchmark import run, spec
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def _stale_apply(monkeypatch):
    """Every apply hands back what the one before it produced: the step
    returns its state unchanged."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.apply
    last = {}

    def apply(self, fields, *args, **kwargs):
        out = original(self, fields, *args, **kwargs)
        prev = last.get("out")
        last["out"] = out
        return out if prev is None else prev

    monkeypatch.setattr(TransferOperator, "apply", apply)


def _unwritten_sink(monkeypatch):
    """The mesh path returns its values but writes nothing: the sink keeps
    the previous job's values."""
    from multimesh_tpu_torch import engine

    original = engine._stream_expand_write

    class Discard(dict):
        def __setitem__(self, key, value):
            pass

    def write_nothing(open_sink, *args, **kwargs):
        return original(lambda params: Discard(), *args, **kwargs)

    monkeypatch.setattr(engine, "_stream_expand_write", write_nothing)


def _half_left_out(monkeypatch):
    """The second half of every batch of targets is never located."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.__dict__["build"]

    def build(cls, *args, **kwargs):
        op = original.__func__(cls, *args, **kwargs)
        half = op.n_points // 2
        op.elements[half:] = -1
        op.found[half:] = False
        return op

    monkeypatch.setattr(TransferOperator, "build", classmethod(build))


def _altered(monkeypatch):
    """Every other apply call alters its answer by 1e-3 where it is
    produced."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.apply
    calls = {"n": 0}

    def apply(self, fields, *args, **kwargs):
        out = original(self, fields, *args, **kwargs)
        calls["n"] += 1
        if calls["n"] % 2:
            return out
        if isinstance(out, tuple):  # out_chunks=True: (chunks, chunk)
            return [c * (1 + 1e-3) for c in out[0]], out[1]
        return out * (1 + 1e-3)

    monkeypatch.setattr(TransferOperator, "apply", apply)


FAULTS = {
    "points_1m": [_stale_apply, _half_left_out, _altered],
    "mesh_new_1m": [_unwritten_sink, _stale_apply, _half_left_out, _altered],
    "mesh_refresh_1m": [_unwritten_sink, _stale_apply, _altered],
}


@pytest.mark.parametrize("mix,fault", [(m, f) for m, fs in FAULTS.items()
                                       for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(root, monkeypatch, mix, fault):
    fault(monkeypatch)
    cell = spec.load_cell(f"tiny.{mix}", root)
    result = run.run_cell(cell, 2**31 + 4001, 0.3, False, "cpu")
    assert result["attempted"] >= 1
    assert not result["correct"], result["checks"]
    assert result["checks"]["max_rel_err"]["value"] > \
        result["checks"]["max_rel_err"]["limit"]


def test_the_sound_program_is_correct_on_the_same_seed(root):
    cell = spec.load_cell("tiny.mesh_new_1m", root)
    result = run.run_cell(cell, 2**31 + 4001, 0.3, False, "cpu")
    assert result["correct"], result["checks"]
    assert torch.isfinite(torch.tensor(
        result["checks"]["max_rel_err"]["value"]))
