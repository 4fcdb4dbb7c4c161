"""The layered cell (``kinds/layered.py``, configuration
``gll4_shell_e4096_l4``, mix ``layered_4x``) rehearsed on the CPU at a
tiny size: correct when sound, and not when the path takes values across
an interface, leaves a layer unwritten or is off by 1e-3; its four
readers on a traced layered stretch, on a traced mesh stretch and on
hand-made counts."""
import json

import numpy as np
import pytest

from benchmark import roofline, run, spec
from benchmark.tests import tiny

CELL = "tiny.layered_4x"
READERS = ["layered.dedup_s_per_job", "layered.apply_write_s_per_job",
           "layered.dedup_card_pct", "layered.k2_nearest_centroid_roofline"]


def make_root(tmp):
    """A tiny checkout (``tiny.make_root``) plus the cell
    ``tiny.layered_4x``: the real configuration and mix cut to a
    288-element source and a 72-element target, 4 layers each, added as
    new files and entries."""
    root = tiny.make_root(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny.REPO / "benchmark/configs/gll4_shell_e4096_l4.json")
                     .read_text())
    cfg["mesh"].update(n_lat=6, n_lon=6, n_rad=8)
    (root / "benchmark/configs/tiny_l4.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny.REPO / "benchmark/traffic/layered_4x.json")
                     .read_text())
    mix["target_mesh"].update(n_lat=3, n_lon=3, n_rad=8)
    mix["check_rows_per_job"] = 64
    mix["trace_seconds"] = 0.2
    (root / "benchmark/traffic/tiny_layered_4x.json").write_text(
        json.dumps(mix))
    bench["configs"].append({"name": "tiny_l4", "source": "a test",
                             "file": "benchmark/configs/tiny_l4.json",
                             "reduced": [], "why": "CPU rehearsal"})
    bench["workloads"].append({"name": CELL, "config": "tiny_l4",
                               "traffic": "tiny_layered_4x", "chips": 1,
                               "why": "CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gll4_e4096.layered_4x" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_is_correct(root, trace):
    cell = spec.load_cell(CELL, root)
    assert [m["name"] for m in cell.end_to_end] == [
        "setup_s", "mpts_per_s", "peak_mem_gib"]
    assert [m["name"] for m in cell.per_layer] == [
        "transfer.build_s_per_mrow", "locate.k1_launches_per_mrow",
        "locate.retry_pct", "k1_newton_rows_roofline", "device.idle_pct",
        "locate.round1_s_per_mrow", "locate.rescue_s_per_mrow",
        "locate.k1_rows_per_mrow", "locate.round1_miss_pct", *READERS]
    result = run.run_cell(cell, 2**31 + 977, 0.3, bool(trace), "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"] == {}
    assert result["checks"]["max_rel_err"]["value"] < 2e-6


def test_a_job_writes_every_slot_of_a_nan_target(root):
    """``prepare`` hands a rotated target whose fields are all NaN; the
    job writes every slot; ``keep`` samples a quarter of its rows on the
    interfaces, each with its own layer."""
    cell = spec.load_cell(CELL, root)
    Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
    jobs = Jobs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    new = jobs.prepare(1)
    params = cell.config["parameters"]
    assert new.points.shape == (72, 125, 3)
    assert not np.allclose(new.points, jobs.target.numpy())  # rotated
    assert all(np.isnan(new.element_nodal_fields[p]).all() for p in params)
    out = jobs.run(new)
    assert all(np.isfinite(out.element_nodal_fields[p]).all()
               for p in params)
    jobs.keep(1, new, out)
    (points,), (values,), (groups,) = (jobs.answers.points,
                                       jobs.answers.values,
                                       jobs.answers.groups)
    assert values.shape == (64, 4) and groups.shape == (64,)
    r = np.linalg.norm(points.numpy(), axis=-1)
    iface = 3.48e6 + (6.371e6 - 3.48e6) * np.arange(1, 4) / 4
    on = np.isclose(r[:, None], iface, rtol=1e-12, atol=0).any(axis=1)
    assert on[-16:].all() and not on[:-16].any()
    assert set(groups.tolist()) == {1, 2, 3, 4}


def _group_blind(monkeypatch):
    """The path ignores the layers: every layer's mask holds every
    element, so each slot is located among all the source's elements and
    an interface slot may take the other side's value."""
    from multimesh_tpu_torch import engine

    original = engine.mesh_layer_masks

    def blind(mesh, layers):
        masks, ids = original(mesh, layers)
        return {k: np.ones_like(v) for k, v in masks.items()}, ids

    monkeypatch.setattr(engine, "mesh_layer_masks", blind)


def _layer_unwritten(monkeypatch):
    """The path builds every layer's operator but writes one layer's
    slots not at all: they keep the target's NaN."""
    from multimesh_tpu_torch import engine

    original = engine._layered_operators

    def drop_one(*args, **kwargs):
        ops, src_masks, tgt_masks = original(*args, **kwargs)
        ops.pop(sorted(ops)[0])
        return ops, src_masks, tgt_masks

    monkeypatch.setattr(engine, "_layered_operators", drop_one)


def _altered(monkeypatch):
    """Every apply alters its answer by 1e-3 where it is produced."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.apply

    def apply(self, fields, *args, **kwargs):
        return original(self, fields, *args, **kwargs) * (1 + 1e-3)

    monkeypatch.setattr(TransferOperator, "apply", apply)


@pytest.mark.parametrize("fault", [_group_blind, _layer_unwritten, _altered],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    cell = spec.load_cell(CELL, root)
    result = run.run_cell(cell, 2**31 + 4001, 0.3, False, "cpu")
    assert result["attempted"] >= 1
    assert not result["correct"], result["checks"]
    assert result["checks"]["max_rel_err"]["value"] > \
        result["checks"]["max_rel_err"]["limit"]


def _traced_readings(root, cell_name, monkeypatch):
    """The four readers on the context of one traced CPU stretch of
    ``cell_name``, read while the stretch's counters are live; the CPU
    has no device time, so K2's is a stand-in 1 ms."""
    readings = {}
    per_layer = run._per_layer

    def spy(*args):
        ctx, breakdown = per_layer(*args)
        ctx = {**ctx, "k2_device_s": 1e-3}
        readings.update({name: spec.metric_reader(name, root / "benchmark")(
            ctx) for name in READERS})
        readings["stages"] = ctx["stages"]
        return ctx, breakdown

    monkeypatch.setattr(run, "_per_layer", spy)
    result = run.run_cell(spec.load_cell(cell_name, root), 2**31 + 1201,
                          0.2, True, "cpu")
    assert result["correct"], result["checks"]
    return readings


def test_readers_read_the_layered_stretch_and_not_a_mesh_one(root,
                                                             monkeypatch):
    got = _traced_readings(root, CELL, monkeypatch)
    assert got["layered.dedup_s_per_job"] > 0
    assert got["layered.apply_write_s_per_job"] > 0
    assert got["layered.dedup_card_pct"] == 0.0  # the host lexsort
    assert 0 < got["layered.k2_nearest_centroid_roofline"] < 100
    assert (got["stages"]["layered.dedup"]
            <= got["stages"]["layered.masks_dedup"])
    mesh = _traced_readings(root, "tiny.mesh_new_1m", monkeypatch)
    assert {name: mesh[name] for name in READERS} == dict.fromkeys(READERS)


def test_k2_roofline_from_the_pairs_counted(monkeypatch):
    from multimesh_tpu_torch import utils_profile

    counters = {"k2.rows": 4 * 1_354_261, "k2.pairs": 4 * 1_354_261 * 1024}
    monkeypatch.setattr(utils_profile, "counter_totals",
                        lambda: dict(counters))
    read = spec.metric_reader("layered.k2_nearest_centroid_roofline")
    ctx = {"stages": {"layered.build": 1.0}, "k2_device_s": 0.01}
    # by hand: 3 f32 FMAs a pair, 2 FLOP each; an f64 query and an int32
    # pick a row
    flop, nbytes = 6 * counters["k2.pairs"], 28 * counters["k2.rows"]
    assert flop / roofline.PEAK_F32 > nbytes / roofline.PEAK_BYTES
    assert read(ctx) == pytest.approx(100 * flop / roofline.PEAK_F32 / 0.01)
    assert read({**ctx, "stages": {"operator.build": 1.0}}) is None
    assert read({**ctx, "k2_device_s": 0.0}) is None
    counters.clear()  # a program without the counters
    assert read(ctx) is None


@pytest.mark.parametrize("name,stage", [
    ("layered.dedup_s_per_job", "layered.dedup"),
    ("layered.apply_write_s_per_job", "layered.apply_write")])
def test_layered_seconds_per_job(name, stage):
    read = spec.metric_reader(name)
    stages = {"layered.masks_dedup": 3.1, "layered.dedup": 3.0,
              "layered.build": 0.8, "layered.apply_write": 0.6}
    assert read({"stages": stages, "jobs": 4}) == pytest.approx(
        stages[stage] / 4)
    assert read({"stages": {"g2g.dedup": 0.1}, "jobs": 4}) is None
    assert read({"stages": stages, "jobs": 0}) is None


def test_dedup_card_pct_reads_the_rows_grouped_on_the_card(monkeypatch):
    from multimesh_tpu_torch import utils_profile

    counters = {"dedup.host_rows": 10_267_500}
    monkeypatch.setattr(utils_profile, "counter_totals",
                        lambda: dict(counters))
    read = spec.metric_reader("layered.dedup_card_pct")
    ctx = {"stages": {"layered.masks_dedup": 3.1}}
    assert read(ctx) == 0.0
    counters["dedup.card_rows"] = 3 * 10_267_500
    assert read(ctx) == pytest.approx(75.0)
    counters.clear()
    assert read(ctx) == 0.0
    assert read({"stages": {"g2g.fingerprint": 0.1}}) is None
