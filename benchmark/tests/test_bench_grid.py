"""The regular-grid cell (``kinds/grid.py``, configuration
``gll4_shell_e4096_grid``, mix ``grid_216``) rehearsed on the CPU at a
tiny size: correct when sound, and not when an outside row reads
anything but 0, an inside value is off by 1e-3, inside rows are left NaN
or read the sentinel 0; its three readers on a traced grid stretch, on a
traced point stretch and on hand-made stages and counts."""
import json

import numpy as np
import pytest

from benchmark import roofline, run, spec
from benchmark.tests import tiny

CELL = "tiny.grid_216"
READERS = ["locate.retry_s_per_mrow", "regular.host_s_per_job",
           "regular.k1_newton_rows_roofline"]


def make_root(tmp):
    """A tiny checkout (``tiny.make_root``) plus the cell
    ``tiny.grid_216``: the real configuration cut to an 80-element source
    and the real mix to a 10^3 grid, added as new files and entries."""
    root = tiny.make_root(tmp)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((tiny.REPO / "benchmark/configs/gll4_shell_e4096_grid"
                      ".json").read_text())
    cfg["mesh"].update(n_lat=4, n_lon=4, n_rad=5)
    (root / "benchmark/configs/tiny_grid.json").write_text(json.dumps(cfg))
    mix = json.loads((tiny.REPO / "benchmark/traffic/grid_216.json")
                     .read_text())
    for axis in ("lat_deg", "lon_deg", "depth_m"):
        mix[axis][2] = 10
    mix["check_rows_per_job"] = mix["outside_rows_per_job"] = 16
    mix["trace_seconds"] = 0.2
    (root / "benchmark/traffic/tiny_grid_216.json").write_text(
        json.dumps(mix))
    bench["configs"].append({"name": "tiny_grid", "source": "a test",
                             "file": "benchmark/configs/tiny_grid.json",
                             "reduced": [], "why": "CPU rehearsal"})
    bench["workloads"].append({"name": CELL, "config": "tiny_grid",
                               "traffic": "tiny_grid_216", "chips": 1,
                               "why": "CPU rehearsal"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "gll4_e4096.grid_216" in m.get("workloads", []):
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
        "locate.retry_pct", "k2_nearest_centroid_roofline",
        "device.idle_pct", "locate.round1_s_per_mrow",
        "locate.rescue_s_per_mrow", "locate.k1_rows_per_mrow",
        "locate.round1_miss_pct", *READERS]
    result = run.run_cell(cell, 2**31 + 2501, 0.3, bool(trace), "cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"] == {}
    assert result["checks"]["max_rel_err"]["value"] < 2e-6


def test_jobs_shift_the_grid_and_sample_inside_and_outside_rows(root):
    """``prepare`` shifts lat and lon by at most ``shift_max_deg`` and
    keeps depth; ``keep`` hands the sampled inside rows, and no more, to
    the check when every outside row reads 0."""
    cell = spec.load_cell(CELL, root)
    Jobs = spec.job_kind(cell.traffic["kind"], cell.base)
    jobs = Jobs(cell.config, cell.traffic, 2**31 + 5, "cpu")
    lat, lon, depth = jobs.prepare(1)
    assert lat != jobs.prepare(2)[0]
    for got, want in ((lat, cell.traffic["lat_deg"]),
                      (lon, cell.traffic["lon_deg"])):
        assert abs(got[0] - want[0]) <= 0.5
        assert got[1] - got[0] == pytest.approx(want[1] - want[0])
    assert list(depth) == cell.traffic["depth_m"]
    ds = jobs.run((lat, lon, depth))
    jobs.keep(1, (lat, lon, depth), ds)
    (points,), (values,) = jobs.answers.points, jobs.answers.values
    assert points.shape == (16, 3) and values.shape == (16, 3)
    assert (values != 0).all()
    r = np.linalg.norm(points.numpy(), axis=-1)
    assert ((r > 3.48e6) & (r < 6.371e6)).all()


def _outside_nonzero(monkeypatch):
    """Every row that no element holds reads 1 in place of 0."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.apply

    def apply(self, fields, *args, **kwargs):
        out = original(self, fields, *args, **kwargs)
        return out + (~self.found)[:, None].to(out.dtype)

    monkeypatch.setattr(TransferOperator, "apply", apply)


def _altered(monkeypatch):
    """Every apply alters its answer by 1e-3 where it is produced."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.apply

    def apply(self, fields, *args, **kwargs):
        return original(self, fields, *args, **kwargs) * (1 + 1e-3)

    monkeypatch.setattr(TransferOperator, "apply", apply)


def _inside_nan(monkeypatch):
    """Every row an element holds is left NaN."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.apply

    def apply(self, fields, *args, **kwargs):
        out = original(self, fields, *args, **kwargs)
        return out.masked_fill(self.found[:, None], float("nan"))

    monkeypatch.setattr(TransferOperator, "apply", apply)


def _inside_sentinel(monkeypatch):
    """No row is located: every row, inside ones too, reads the
    sentinel 0."""
    from multimesh_tpu_torch import TransferOperator

    original = TransferOperator.__dict__["build"]

    def build(cls, *args, **kwargs):
        op = original.__func__(cls, *args, **kwargs)
        op.elements[:] = -1
        op.found[:] = False
        return op

    monkeypatch.setattr(TransferOperator, "build", classmethod(build))


@pytest.mark.parametrize("fault", [_outside_nonzero, _altered, _inside_nan,
                                   _inside_sentinel],
                         ids=lambda f: f.__name__)
def test_a_broken_path_is_not_correct(root, monkeypatch, fault, capsys):
    fault(monkeypatch)
    cell = spec.load_cell(CELL, root)
    result = run.run_cell(cell, 2**31 + 4001, 0.3, False, "cpu")
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert not result["correct"], result["checks"]
    assert result["checks"]["max_rel_err"]["value"] > \
        result["checks"]["max_rel_err"]["limit"]
    said = "reads [1.0, 1.0, 1.0], not 0" in capsys.readouterr().err
    assert said == (fault is _outside_nonzero)


def _traced_readings(root, cell_name, monkeypatch):
    """The three readers on the context of one traced CPU stretch of
    ``cell_name``, read while the stretch's counters are live; the CPU
    has no device time, so K1's is a stand-in 1 s."""
    readings = {}
    per_layer = run._per_layer

    def spy(*args):
        ctx, breakdown = per_layer(*args)
        ctx = {**ctx, "k1_device_s": 1.0}
        readings.update({name: spec.metric_reader(name, root / "benchmark")(
            ctx) for name in READERS})
        readings["stages"] = ctx["stages"]
        from multimesh_tpu_torch import utils_profile

        readings["counters"] = utils_profile.counter_totals()
        readings["ctx"] = ctx
        return ctx, breakdown

    monkeypatch.setattr(run, "_per_layer", spy)
    result = run.run_cell(spec.load_cell(cell_name, root), 2**31 + 1201,
                          0.2, True, "cpu")
    assert result["correct"], result["checks"]
    return readings


def test_readers_read_the_grid_stretch_and_not_a_point_one(root,
                                                           monkeypatch):
    got = _traced_readings(root, CELL, monkeypatch)
    ctx, counters = got["ctx"], got["counters"]
    jobs = ctx["jobs"]
    assert counters["regular.points"] == jobs * 1000
    assert ctx["rows_located"] == jobs * 1000
    assert counters["ladder.retry.rows"] == ctx["retry_rows"] > 0
    assert counters["points.sentinel_rows"] > 0
    assert got["locate.retry_s_per_mrow"] == pytest.approx(
        got["stages"]["locate.retry"] / (jobs * 1000 / 1e6))
    assert got["regular.host_s_per_job"] > 0
    flop, nbytes = roofline.newton_work(
        counters["k1.rows"], ctx["distinct_elements"], 4, 3, 18)
    assert got["regular.k1_newton_rows_roofline"] == pytest.approx(
        100 * max(flop / roofline.PEAK_F32, nbytes / roofline.PEAK_BYTES))
    # a point stretch: round 1 ran and no retry did; no export ran
    point = _traced_readings(root, "tiny.points_1m", monkeypatch)
    assert point["locate.retry_s_per_mrow"] == 0.0
    assert point["regular.host_s_per_job"] is None
    assert point["regular.k1_newton_rows_roofline"] is None


def test_retry_seconds_per_mrow():
    read = spec.metric_reader("locate.retry_s_per_mrow")
    stages = {"locate.round1": 0.4, "locate.retry": 1.2}
    ctx = {"stages": stages, "rows_located": 3_000_000,
           "retry_rows": 1_000_000}
    assert read(ctx) == pytest.approx(0.4)
    # the stage opens with no row to retry: its microseconds read 0
    assert read({**ctx, "retry_rows": 0}) == 0.0
    assert read({**ctx, "stages": {"g2g.dedup": 0.1}}) is None
    assert read({**ctx, "rows_located": 0}) is None


def test_host_seconds_per_job():
    read = spec.metric_reader("regular.host_s_per_job")
    stages = {"regular.make_points": 0.5, "regular.pull": 0.2,
              "regular.assemble": 0.1, "operator.build": 2.0}
    assert read({"stages": stages, "jobs": 4}) == pytest.approx(0.2)
    assert read({"stages": {"operator.build": 2.0}, "jobs": 4}) is None
    assert read({"stages": stages, "jobs": 0}) is None


def test_k1_roofline_from_the_rows_counted(monkeypatch):
    from multimesh_tpu_torch import utils_profile

    counters = {"k1.rows": 90_000_000}
    monkeypatch.setattr(utils_profile, "counter_totals",
                        lambda: dict(counters))
    read = spec.metric_reader("regular.k1_newton_rows_roofline")
    ctx = {"stages": {"regular.make_points": 0.5}, "k1_device_s": 0.2,
           "distinct_elements": 4096, "order": 4, "dim": 3,
           "newton_iters": 18}
    # by hand: per row 3 components x (18 evaluations of x and J, 2 n^3 +
    # 3 n^2 + 4 n FMAs, and one of x, n^3 + n^2 + n), n = 5, 2 FLOP each
    per_row = 2 * 3 * (18 * (250 + 75 + 20) + (125 + 25 + 5))
    assert per_row * 90e6 / roofline.PEAK_F32 > (
        44 * 90e6 + 4096 * (32 + 12 * 125)) / roofline.PEAK_BYTES
    assert read(ctx) == pytest.approx(
        100 * per_row * 90e6 / roofline.PEAK_F32 / 0.2)
    assert read({**ctx, "stages": {"operator.build": 1.0}}) is None
    assert read({**ctx, "k1_device_s": 0.0}) is None
    counters.clear()  # a program without the counter
    assert read(ctx) is None


def test_a_whole_job_matches_the_plain_reference(root):
    """``grid_check.whole_job`` on the tiny cell: every inside row within
    float32 accuracy of ``reference_grid.py``, every outside row 0 in
    both, the bfloat16 control above the limit."""
    from benchmark import grid_check

    cell = spec.load_cell(CELL, root)
    got = grid_check.whole_job(cell, 2**31 + 77, "cpu", block=256)
    assert got["points"] == 1000 and got["coordinates_equal"]
    assert got["share_inside"] > 0.1 and got["share_outside"] > 0.3
    assert got["inside_nonzero"]
    assert got["max_rel_err_inside"] < 2e-6
    assert got["outside_zero"] and got["outside_zero_reference"]
    assert got["bf16_max_rel_err_inside"] > cell.config["check"][
        "max_rel_err"]
    assert got["band_agree_share"] == 1.0
