"""The Exodus-to-GLL cell (``kinds/exodus_gll.py``, configuration
``exo1_shell_e57600``, mix ``gll_10m``) rehearsed on the CPU at a tiny
size: correct when sound and not when its path is broken; its three
readers and K1's roofline at order 1 on hand-made contexts; the plain reference at order 1 against the
trilinear formula; and the corners and fields it hands the program
against what ``exodus_2_gll`` reads out of an Exodus file."""
import json

import numpy as np
import pytest
import torch

from benchmark import reference, run, spec
from benchmark.tests import tiny

CELL = "tiny.gll_10m"


def make_root(tmp):
    """A tiny checkout (``tiny.make_root``) plus the cell ``tiny.gll_10m``:
    the real configuration and mix cut to 640 hexes and a 27-element
    target, added as new files and entries."""
    root = tiny.make_root(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny.REPO / "benchmark/configs/exo1_shell_e57600.json")
                     .read_text())
    cfg["mesh"].update(n_lat=10, n_lon=8, n_rad=8)
    (root / "benchmark/configs/tiny_exo.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny.REPO / "benchmark/traffic/gll_10m.json")
                     .read_text())
    mix["target_mesh"].update(n_lat=3, n_lon=3, n_rad=3)
    mix["check_rows_per_job"] = 32
    mix["trace_seconds"] = 0.2
    (root / "benchmark/traffic/tiny_gll_10m.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "tiny_exo", "source": "a test",
                             "file": "benchmark/configs/tiny_exo.json",
                             "reduced": [], "why": "CPU rehearsal"})
    bench["workloads"].append({"name": CELL, "config": "tiny_exo",
                               "traffic": "tiny_gll_10m", "chips": 1,
                               "why": "CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "exo1_e57600.gll_10m" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_is_correct(root, trace):
    cell = spec.load_cell(CELL, root)
    assert [m["name"] for m in cell.per_layer] == [
        "transfer.build_s_per_mrow", "locate.k1_launches_per_mrow",
        "locate.retry_pct", "k1_newton_rows_roofline", "device.idle_pct",
        "locate.round1_s_per_mrow", "locate.rescue_s_per_mrow",
        "locate.k1_rows_per_mrow", "locate.round1_miss_pct",
        "grid.search_s_per_mrow", "e2g.locate_s_per_mrow",
        "e2g.apply_s_per_job", "e2g.write_s_per_job"]
    result = run.run_cell(cell, 2**31 + 977, 0.3, bool(trace), "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"] == {}
    assert result["checks"]["max_rel_err"]["value"] < 2e-6


def test_every_slot_is_written_through_the_path(root, monkeypatch):
    from multimesh_tpu_torch import engine

    calls = []
    original = engine.exodus_2_gll_arrays

    def spy(*args, **kwargs):
        calls.append(args[3].shape)
        return original(*args, **kwargs)

    monkeypatch.setattr(engine, "exodus_2_gll_arrays", spy)
    cell = spec.load_cell(CELL, root)
    Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
    jobs = Jobs(cell.config, cell.traffic, 7, "cpu")
    coords = jobs.prepare(1)
    assert coords.dtype == np.float32 and coords.shape == (27, 125, 3)
    jobs.sink.array[:] = np.nan
    out = jobs.run(coords)
    assert calls == [(27, 125, 3)]
    assert out is jobs.sink.array and np.isfinite(out).all()
    assert jobs.points_per_job == 27 * 125
    assert out.dtype == np.float32  # the sink takes the path's f32 blocks


def _unwritten_sink(monkeypatch):
    """The path locates and applies but writes nothing: the sink keeps
    the previous job's values (zeros before the first)."""
    from multimesh_tpu_torch import engine

    monkeypatch.setattr(engine, "_stream_pull_write",
                        lambda sink, out_dev, *a, **k: None)


def _altered(monkeypatch):
    """Every other apply call alters its answer by 1e-3 where it is
    produced."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.apply
    calls = {"n": 0}

    def apply(self, fields, *args, **kwargs):
        out = original(self, fields, *args, **kwargs)
        calls["n"] += 1
        return out if calls["n"] % 2 else out * (1 + 1e-3)

    monkeypatch.setattr(TransferOperator, "apply", apply)


@pytest.mark.parametrize("fault", [_unwritten_sink, _altered],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    cell = spec.load_cell(CELL, root)
    result = run.run_cell(cell, 2**31 + 4001, 0.3, False, "cpu")
    assert result["attempted"] >= 1
    assert not result["correct"], result["checks"]
    assert result["checks"]["max_rel_err"]["value"] > \
        result["checks"]["max_rel_err"]["limit"]


def _ctx(stages, rows=9_925_250, jobs=4, **extra):
    return {"jobs": jobs, "rows_located": rows, "stages": dict(stages),
            **extra}


E2G = {"e2g.locate": 2.4, "operator.build": 2.3, "e2g.apply": 0.2,
       "e2g.stream_write": 0.6}


def test_locate_seconds_per_mrow():
    read = spec.metric_reader("e2g.locate_s_per_mrow")
    assert read(_ctx(E2G)) == pytest.approx(2.4 / 9.92525)
    # a program without the span (the parent of the span's change)
    assert read(_ctx({k: v for k, v in E2G.items() if k != "e2g.locate"})) \
        is None
    assert read(_ctx(E2G, rows=0)) is None


@pytest.mark.parametrize("name,stage", [("e2g.apply_s_per_job", "e2g.apply"),
                                        ("e2g.write_s_per_job",
                                         "e2g.stream_write")])
def test_apply_and_write_seconds_per_job(name, stage):
    read = spec.metric_reader(name)
    assert read(_ctx(E2G)) == pytest.approx(E2G[stage] / 4)
    assert read(_ctx({"g2g.apply": 0.2, "g2g.stream_write": 0.6})) is None
    assert read(_ctx(E2G, jobs=0)) is None


def test_k1_order1_roofline():
    """K1's roofline reader at the Exodus source's order 1
    (``newton_rows_kernel<1, 3>``)."""
    from benchmark import roofline

    read = spec.metric_reader("k1_newton_rows_roofline")
    rows, elems = 4 * 9_925_250, 57_600
    ctx = _ctx(E2G, rows=rows, order=1, dim=3, newton_iters=18,
               distinct_elements=elems, k1_device_s=0.05)
    # by hand: 3 components x (18 x 36 + 14) FMAs of 2 FLOP a row, in f32
    flop = 2 * 3 * (18 * (2 * 8 + 3 * 4 + 4 * 2) + (8 + 4 + 2)) * rows
    nbytes = (8 * 3 + 4 + 4 * 3 + 4) * rows + (8 * 3 + 8 + 4 * 3 * 8) * elems
    assert roofline.newton_work(rows, elems, 1, 3, 18) == (flop, nbytes)
    least = max(flop / roofline.PEAK_F32, nbytes / roofline.PEAK_BYTES)
    assert read(ctx) == pytest.approx(100 * least / 0.05)
    assert read({**ctx, "k1_device_s": 0.0}) is None
    assert read({**ctx, "order": 4}) != pytest.approx(read(ctx))
    assert read({**ctx, "rows_located": 0}) is None


def test_reference_at_order_1_is_the_trilinear_formula():
    rng = np.random.default_rng(3)
    ref = np.array([[2 * i - 1, 2 * j - 1, 2 * k - 1] for i in (0, 1)
                    for j in (0, 1) for k in (0, 1)], np.float64)
    corners = ref * np.array([2.0, 1.5, 1.0]) + rng.uniform(-0.3, 0.3,
                                                            (8, 3))
    xi = rng.uniform(-1.0, 1.0, (64, 3))
    # the 8 weights written out: prod over axes of (1 + c_a xi_a) / 2
    w = np.prod((1.0 + xi[:, None, :] * ref[None]) / 2.0, axis=-1)
    got = reference.basis(1, torch.as_tensor(xi)).numpy()
    np.testing.assert_allclose(got, w, rtol=0, atol=1e-12)
    pts = torch.as_tensor(w @ corners)
    lattice = torch.as_tensor(corners)[None]
    e, back, found = reference.locate(lattice, pts, 1)
    assert found.all() and (e == 0).all()
    np.testing.assert_allclose(back.numpy(), xi, rtol=0, atol=1e-12)
    values = torch.as_tensor(rng.uniform(1.0, 2.0, (2, 1, 8)))
    np.testing.assert_allclose(
        reference.interpolate(values, e, back, 1).numpy(),
        (w @ values[:, 0].numpy().T), rtol=1e-12)


def test_the_corners_and_fields_are_what_exodus_2_gll_reads(root, tmp_path):
    from multimesh_tpu_torch import testing
    from multimesh_tpu_torch.core import gll
    from multimesh_tpu_torch.io import exodus

    # the canonical order is the order-1 lattice's
    exodus_ref = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1],
                           [-1, 1, -1], [-1, -1, 1], [1, -1, 1], [1, 1, 1],
                           [-1, 1, 1]], np.float64)
    np.testing.assert_array_equal(exodus_ref[exodus.HEX8_TO_CANONICAL],
                                  gll.lattice_coords(1, 3))
    cell = spec.load_cell(CELL, root)
    Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
    jobs = Jobs(cell.config, cell.traffic, 7, "cpu")
    mesh = {k: v for k, v in cell.config["mesh"].items() if k != "maker"}
    m = testing.shell_mesh(**mesh)
    path = tmp_path / "source.e"
    testing.write_exodus_fixture(path, m, parameters=cell.config[
        "parameters"])
    exo = exodus.Exodus(path)
    assert not jobs.source.lattice.flags.writeable
    np.testing.assert_allclose(jobs.source.lattice,
                               exo.canonical_corner_nodes(), rtol=1e-14,
                               atol=0)
    conn = exo.canonical_connectivity()
    read = np.stack([exo.get_nodal_field(p)[conn]
                     for p in cell.config["parameters"]])
    np.testing.assert_allclose(jobs.fields, read, rtol=1e-14, atol=0)
    # corner c of every hex lies on the side of its centre that
    # lattice_coords(1, 3)[c] names, along (r, theta, phi)
    lat = jobs.source.lattice
    r = np.linalg.norm(lat, axis=-1)
    sph = np.stack([r, np.arccos(lat[..., 2] / r),
                    np.arctan2(lat[..., 1], lat[..., 0])], -1)
    side = np.sign(sph - sph.mean(axis=1, keepdims=True))
    assert (side == gll.lattice_coords(1, 3)[None]).all()
    # a vertex shared by hexes carries the same bits in each
    flat = lat.reshape(-1, 3)
    _, first, inverse = np.unique(flat, axis=0, return_index=True,
                                  return_inverse=True)
    vals = jobs.fields.reshape(len(cell.config["parameters"]), -1)
    assert np.array_equal(vals, vals[:, first[inverse.ravel()]])
