"""The port's span recorder and counters (``utils_profile``) on the CPU:
nothing recorded or printed with ``MMT_PROFILE`` unset; with it set, the
spans nest in a ``torch.profiler`` trace as the code nests, the ladder's
row counters add up and agree with a plain re-count, the event-timed path
resolves its pending pairs when read, and ``report()`` writes to
standard error only."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch import utils_profile as tprofile  # noqa: E402
from multimesh_tpu_torch.config import LocateConfig  # noqa: E402
from multimesh_tpu_torch.search import grid as tgrid  # noqa: E402
from multimesh_tpu_torch.search import knn as tknn  # noqa: E402
from multimesh_tpu_torch.search import locate as tlocate  # noqa: E402
from multimesh_tpu_torch.search import newton as tnewton  # noqa: E402

CFG = LocateConfig(nelem_to_search=20)
ROUNDS = [f"ladder.round{r}.rows" for r in (1, 2, 3, 4)]


@pytest.fixture(scope="module")
def mesh():
    """An order-4 shell of 75 elements (above the 64 below which round 1
    takes exact top-k columns, so round 1 is the nearest centroid)."""
    return tmt.shell_mesh(n_lat=5, n_lon=5, n_rad=3, order=4,
                          lat_extent=(0.5, 1.2), lon_extent=(0.3, 1.4))


def _targets(mesh, n, outside, seed=0):
    """``n`` points spread over the shell's lattice, the last ``outside``
    of them moved out to 1.2 times its outer radius (more than round 4
    takes of a chunk of up to 1,024 rows, 128, so the scan retry runs)."""
    rng = np.random.default_rng(seed)
    nodes = mesh.points.reshape(-1, 3)
    a = nodes[rng.integers(0, len(nodes), n)]
    b = nodes[rng.integers(0, len(nodes), n)]
    pts = a + rng.uniform(0.0, 0.05, (n, 1)) * (b - a)
    out = pts[n - outside:]
    out *= 1.2 * np.linalg.norm(nodes, axis=1).max() / np.linalg.norm(
        out, axis=1, keepdims=True)
    return pts


def _on(monkeypatch):
    monkeypatch.setenv("MMT_PROFILE", "1")
    tprofile.reset_stages()


def _ranges(prof):
    """[(name, start_ns, end_ns)] of the trace's ``mmt.*`` and caller
    ranges on the host."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("mmt.", "job")):
            out.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return out


def _inside(ranges, inner, *outer):
    """Every ``inner`` range lies inside some range named in ``outer``
    (and there is at least one of each)."""
    inn = [r for r in ranges if r[0] == inner]
    out = [r for r in ranges if r[0] in outer]
    return bool(inn and out) and all(
        any(o[1] <= i[1] and i[2] <= o[2] for o in out) for i in inn)


def test_recording_off_makes_no_event_counter_range_or_output(
        mesh, monkeypatch, capsys):
    monkeypatch.delenv("MMT_PROFILE", raising=False)
    tprofile.reset_stages()

    def refuse(*args, **kwargs):
        raise AssertionError("the recorder ran with recording off")

    monkeypatch.setattr(tprofile._Span, "__enter__", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert tprofile.stage_timer("a") is tprofile.stage_timer("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = tlocate.locate(_targets(mesh, 600, 200), mesh.points, 4, CFG,
                             fallback="snap", device="cpu")
    assert res.n_retry > 0  # every stage of the ladder ran
    assert not [r for r in _ranges(prof) if r[0].startswith("mmt.")]
    assert tprofile.stage_totals() == {}
    assert tprofile.counter_totals() == {}
    assert tprofile.stage_peaks() == {}
    out = capsys.readouterr()
    assert out.out == "" and out.err == ""


def test_spans_nest_in_the_profiler_trace_as_the_code_nests(monkeypatch):
    _on(monkeypatch)
    src = tmt.shell_mesh(n_lat=5, n_lon=5, n_rad=3, order=4,
                         lat_extent=(0.5, 1.2), lon_extent=(0.3, 1.4))
    # the target's outer layer reaches past the source's, so round 1
    # leaves rows unaccepted and the rescue rounds run
    tgt = tmt.shell_mesh(n_lat=2, n_lon=2, n_rad=2, order=4,
                         r_inner=3.6e6, r_outer=6.6e6,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
    data = np.stack([tmt.element_nodal_field(src)] * 2, axis=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("job"):
            tengine.transfer_arrays(
                src.points, data, ["VP", "VS"], tgt.points,
                np.zeros((tgt.nelem, 2, tgt.n_gll)),
                np.ones(tgt.nelem, bool),
                lambda names: np.empty((tgt.nelem, len(names), tgt.n_gll)),
                device="cpu")
    ranges = _ranges(prof)
    assert _inside(ranges, "mmt.locate.round1", "mmt.operator.build")
    assert _inside(ranges, "mmt.locate.rounds23", "mmt.operator.build")
    assert _inside(ranges, "mmt.g2g.pull_wait", "mmt.g2g.stream_write")
    assert _inside(ranges, "mmt.g2g.expand", "mmt.g2g.stream_write")
    assert _inside(ranges, "mmt.operator.build", "job")
    assert _inside(ranges, "mmt.g2g.fingerprint", "job")
    # the recorder's own totals hold the same stages, every one timed
    totals = tprofile.stage_totals()
    assert {n[4:] for n, _, _ in ranges if n.startswith("mmt.")} == set(totals)
    assert all(v > 0 for v in totals.values())


def test_ladder_counters_add_up_and_match_a_plain_recount(mesh,
                                                         monkeypatch):
    _on(monkeypatch)
    pts = _targets(mesh, 900, 300)
    res = tlocate.locate(pts, mesh.points, 4, CFG, fallback="snap",
                         device="cpu")
    counters = tprofile.counter_totals()
    assert res.n_retry > 0
    assert counters["ladder.round1.rows"] == len(pts)
    # the retry scans each of its rows against the full candidate list
    assert counters["k1.rows"] == (sum(counters[r] for r in ROUNDS)
                                   + res.n_retry * CFG.nelem_to_search)
    missed = int((~_round1_accepted(mesh, pts)).sum())
    assert missed >= 300  # the outside points, at least
    assert counters["ladder.round1.missed"] == missed


def _round1_accepted(mesh, pts):
    """Round 1 by hand: the nearest centroid, one Newton solve, the test;
    [N] bool."""
    prep = tlocate._mesh_prep(mesh.points, 4, torch.device("cpu"))
    q = torch.as_tensor(pts, dtype=torch.float64)
    near = tknn.nearest_centroid(prep.centroids, q, plain=True)
    ref, res1 = tnewton.newton_refs_rows_ref(
        q, near, prep.ctr, prep.inv_scale, prep.nodes, 4, 3,
        CFG.newton_iters + CFG.polish_iters, CFG.newton_clamp)
    return (res1 < 1e-4) & (ref.abs().amax(dim=-1) < CFG.accept_tol)


def test_rescue_rounds_are_sized_by_the_misses_and_skipped_without(
        mesh, monkeypatch):
    """Chunks of 256 rows, the outside ones in the last two: a chunk that
    round 1 accepts whole counts one ``ladder.rescue.skipped`` and no
    rescue row; every other chunk retries its misses, at most each
    round's cap, on 3, 4 and 20 columns in rounds 2, 3 and 4."""
    _on(monkeypatch)
    pts = _targets(mesh, 900, 300)
    tlocate.locate(pts, mesh.points, 4, CFG, fallback="snap", device="cpu",
                   chunk=256)
    counters = tprofile.counter_totals()
    accepted = _round1_accepted(mesh, pts)
    missed = [int((~accepted[s:s + 256]).sum()) for s in range(0, 900, 256)]
    assert 0 < missed.count(0) < len(missed) and max(missed) > 128
    assert counters["ladder.rescue.skipped"] == missed.count(0)
    # caps of a 256-row chunk: 256, 256 and 128 rows
    for r, cap, cols in ((2, 256, 3), (3, 256, 4), (4, 128, 20)):
        assert counters[f"ladder.round{r}.rows"] == sum(
            min(cap, m) * cols for m in missed)


def test_grid_route_stages_sit_inside_the_ladder_rounds(mesh, monkeypatch):
    monkeypatch.setattr(tgrid, "APPROX_GRID_MIN_SOURCES", 16)
    _on(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # outside rows: round 1 misses them, so the rescue rounds run
        tlocate.locate(_targets(mesh, 300, 100), mesh.points, 4, CFG,
                       fallback="snap", device="cpu")
    ranges = _ranges(prof)
    rounds = ("mmt.locate.round1", "mmt.locate.rounds23",
              "mmt.locate.round4")
    assert _inside(ranges, "mmt.grid.probe_bins", *rounds)
    assert _inside(ranges, "mmt.grid.rank_members", *rounds)
    calls = dict(tprofile._REC.calls)
    assert calls["grid.probe_bins"] == calls["grid.rank_members"] >= 3


class _FakeEvent:
    """Stands in for ``torch.cuda.Event``: records the fake clock and is
    complete once ``done`` is set."""
    clock = 0.0
    done = False

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.clock

    def query(self):
        return _FakeEvent.done

    def synchronize(self):
        _FakeEvent.done = True

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def test_event_timed_stages_resolve_when_read_and_credit_peaks(monkeypatch):
    peak = [0]
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(
        torch.cuda, "memory_stats_as_nested_dict",
        lambda: {"allocated_bytes": {"all": {"peak": peak[0]}}})
    monkeypatch.setattr(_FakeEvent, "clock", 0.0)
    monkeypatch.setattr(_FakeEvent, "done", False)
    _on(monkeypatch)
    with tprofile.stage_timer("outer"):
        _FakeEvent.clock, peak[0] = 1.0, 100
        with tprofile.stage_timer("inner"):
            _FakeEvent.clock, peak[0] = 3.0, 300
        _FakeEvent.clock = 4.0
    with tprofile.stage_timer("inner"):
        _FakeEvent.clock = 4.5
    # the card has not reached the events: nothing resolved at the ends
    assert len(tprofile._REC.pending) == 3 and tprofile._REC.seconds == {}
    _FakeEvent.done = True
    assert tprofile.stage_totals() == pytest.approx(
        {"outer": 4.0, "inner": 2.5})
    assert tprofile._REC.pending == [] and len(tprofile._REC.free) == 6
    # 0 -> 300 while outer, the outermost stage, ran; the second inner
    # ran outermost and left the peak where it was
    assert tprofile.stage_peaks() == {"outer": 300}
    # a completed pair is resolved at the next stage's end, and its
    # events are recorded again rather than created
    free = list(tprofile._REC.free)
    with tprofile.stage_timer("again"):
        _FakeEvent.clock = 6.0
    assert tprofile._REC.pending == [] and len(tprofile._REC.free) == 6
    assert set(map(id, tprofile._REC.free)) == set(map(id, free))
    assert tprofile.stage_totals()["again"] == pytest.approx(1.5)
    # reading the totals waits for the card's last event
    _FakeEvent.done = False
    with tprofile.stage_timer("again"):
        _FakeEvent.clock = 7.0
    assert len(tprofile._REC.pending) == 1
    assert tprofile.stage_totals()["again"] == pytest.approx(2.5)
    tprofile.count("rows", 5)
    tprofile.count("rows", torch.tensor(7))
    assert tprofile.counter_totals() == {"rows": 12}
    tprofile.reset_stages()
    assert (tprofile.stage_totals(), tprofile.stage_peaks(),
            tprofile.counter_totals()) == ({}, {}, {})


def test_grid_stages_are_one_span_a_query_over_many_row_blocks(
        monkeypatch):
    rng = np.random.default_rng(1)
    src = torch.as_tensor(rng.normal(size=(600, 3)))
    qry = torch.as_tensor(rng.normal(size=(500, 3)))
    index = tgrid.get_grid_index(src.numpy(), 16, torch.device("cpu"))
    want = tgrid.grid_knn(index, qry, 5, n_probe=4)
    # row blocks of a few rows: the two stages still open once a query
    n_bins, _, m = index.bin_coords64.shape
    monkeypatch.setattr(tgrid, "_BLOCK_ENTRIES", 4 * n_bins)
    assert tgrid._row_step(n_bins, 4, 3, m) < 100
    _on(monkeypatch)
    got = tgrid.grid_knn(index, qry, 5, n_probe=4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert tprofile._REC.calls == {"grid.probe_bins": 1,
                                   "grid.rank_members": 1}


def test_report_writes_the_table_to_stderr_only(monkeypatch, capsys):
    _on(monkeypatch)
    with tprofile.stage_timer("g2g.dedup"):
        with tprofile.stage_timer("locate.round1"):
            pass
    tprofile.count("k1.rows", 262_144)
    tprofile.count("ladder.round1.missed", torch.tensor(3))
    tprofile.report()
    out = capsys.readouterr()
    assert out.out == ""
    lines = out.err.splitlines()
    assert lines[0].split()[:2] == ["mmt", "stage"]
    rows = {ln.split()[0]: ln.split()[1:] for ln in lines[1:3]}
    assert set(rows) == {"g2g.dedup", "locate.round1"}
    assert rows["g2g.dedup"][1] == "1"  # one call
    assert all(ln.startswith("mmt counter ") for ln in lines[3:])
    assert {ln.split()[-2]: ln.split()[-1] for ln in lines[3:]} == {
        "k1.rows": "262144", "ladder.round1.missed": "3"}


def test_the_exodus_path_times_its_location_step_once_a_call(monkeypatch):
    """``e2g.locate`` wraps the build and the missing-row check: one span a
    call of ``exodus_2_gll_arrays``, ``operator.build`` and the ladder's
    rounds inside it, the apply and the write after it; recording off,
    nothing is recorded."""
    src = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=3, order=1)
    tgt = tmt.shell_mesh(n_lat=2, n_lon=2, n_rad=2, order=2,
                         r_inner=3.7e6, r_outer=6.2e6,
                         lat_extent=(0.58, 1.12), lon_extent=(0.38, 1.32))
    fields = np.stack([tmt.smooth_field(src.points)] * 2)
    coords = tgt.points.astype(np.float32)

    def call():
        sink = np.zeros((tgt.nelem, 2, tgt.n_gll), np.float32)
        tengine.exodus_2_gll_arrays(src.points, fields, ["VP", "VS"], coords,
                                    lambda names: sink, device="cpu")
        return sink

    monkeypatch.delenv("MMT_PROFILE", raising=False)
    tprofile.reset_stages()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off = call()
    assert not [r for r in _ranges(prof) if r[0].startswith("mmt.")]
    assert tprofile.stage_totals() == {} and tprofile._REC.calls == {}

    _on(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("job"):
            on = call()
        call()
    np.testing.assert_array_equal(on, off)
    ranges = _ranges(prof)
    assert tprofile._REC.calls["e2g.locate"] == 2
    assert tprofile._REC.calls["operator.build"] == 2
    assert _inside(ranges, "mmt.operator.build", "mmt.e2g.locate")
    assert _inside(ranges, "mmt.locate.round1", "mmt.e2g.locate")
    assert not _inside(ranges, "mmt.e2g.apply", "mmt.e2g.locate")
    first = [r for r in ranges if r[0] == "mmt.e2g.locate"][0]
    apply = [r for r in ranges if r[0] == "mmt.e2g.apply"][0]
    assert first[2] <= apply[1]
    assert tprofile.stage_totals()["e2g.locate"] >= \
        tprofile.stage_totals()["operator.build"] > 0


def _layered_pair():
    """Live source and target meshes of 2 layers (72 source elements a
    layer: above 64, so round 1 takes K2's nearest centroid)."""
    import types

    def live(mesh):
        return types.SimpleNamespace(
            points=mesh.points,
            element_nodal_fields={"VP": tmt.smooth_field(mesh.points)},
            elemental_fields={"fluid": np.zeros(mesh.nelem),
                              "layer": mesh.layer_id.astype(np.float64)})

    src = tmt.shell_mesh(n_lat=6, n_lon=6, n_rad=4, order=2, n_layers=2)
    tgt = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=4, order=2, n_layers=2,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
    return live(src), live(tgt), tgt


def test_the_layered_path_nests_its_dedup_and_apply_and_counts_its_work(
        monkeypatch):
    """``layered.dedup`` opens inside ``layered.masks_dedup`` and
    ``layered.apply`` (once a layer) inside ``layered.apply_write``; the
    call counts the layers it carried, the target slots it wrote, and
    K2's queries and (query, centroid) pairs, which the calls of
    ``nearest`` add up to; recording off, nothing is recorded."""
    from multimesh_tpu_torch.search import nearest as tnearest

    calls = []
    original = tnearest.nearest

    def spy(queries, sources):
        calls.append((queries.shape[0], sources.shape[0]))
        return original(queries, sources)

    monkeypatch.setattr(tnearest, "nearest", spy)

    def call():
        old, new, tgt = _layered_pair()
        tengine.gll_2_gll_layered(old, new, layers="all", parameters=["VP"],
                                  device="cpu")
        return new.element_nodal_fields["VP"], tgt

    monkeypatch.delenv("MMT_PROFILE", raising=False)
    tprofile.reset_stages()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        off, _ = call()
    assert not [r for r in _ranges(prof) if r[0].startswith("mmt.")]
    assert tprofile.stage_totals() == {} and tprofile.counter_totals() == {}
    assert calls  # K2 ran, unrecorded

    _on(monkeypatch)
    calls.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("job"):
            on, tgt = call()
    np.testing.assert_array_equal(on, off)
    ranges = _ranges(prof)
    assert _inside(ranges, "mmt.layered.dedup", "mmt.layered.masks_dedup")
    assert _inside(ranges, "mmt.layered.apply", "mmt.layered.apply_write")
    assert not _inside(ranges, "mmt.layered.dedup", "mmt.layered.build")
    assert tprofile._REC.calls["layered.dedup"] == 1
    assert tprofile._REC.calls["layered.apply"] == 2  # one a layer
    counters = tprofile.counter_totals()
    assert counters["layered.layers"] == 2
    assert counters["layered.slots"] == tgt.nelem * tgt.n_gll
    assert {s for _, s in calls} == {72}  # each layer's centroids
    assert counters["k2.rows"] == sum(q for q, _ in calls)
    assert counters["k2.pairs"] == sum(q * s for q, s in calls)
    # the dedup ran on the host, every target slot through it
    assert counters["dedup.host_rows"] == tgt.nelem * tgt.n_gll


def _grid_call(mesh):
    """``extract_regular_grid`` of the fixture's shell onto an 8^3 grid
    that overhangs it on every side; returns (dataset, the operator the
    call built)."""
    import types

    from multimesh_tpu_torch import TransferOperator

    built = []
    original = TransferOperator.__dict__["build"]

    def build(cls, *args, **kwargs):
        built.append(original.__func__(cls, *args, **kwargs))
        return built[-1]

    live = types.SimpleNamespace(
        points=mesh.points,
        element_nodal_fields={"VP": tmt.smooth_field(mesh.points)})
    TransferOperator.build = classmethod(build)
    try:
        ds = tengine.extract_regular_grid(
            live, ["VP"], (15.0, 68.0, 8), (10.0, 88.0, 8), (-1e5, 3e6, 8),
            device="cpu")
    finally:
        TransferOperator.build = original
    (op,) = built
    return ds, op


def test_the_regular_grid_opens_its_host_spans_and_counts_its_rows(
        mesh, monkeypatch):
    """``regular.make_points``, ``regular.pull`` and ``regular.assemble``
    open once a call, apart from one another and from the build; the
    call counts its grid points, the sentinel rows (``op.num_missing``)
    and the rows of the scan retry (``op.n_retry``); recording off,
    nothing is recorded and the dataset is the same."""
    monkeypatch.delenv("MMT_PROFILE", raising=False)
    tprofile.reset_stages()
    off, _ = _grid_call(mesh)
    assert tprofile.stage_totals() == {} and tprofile.counter_totals() == {}

    _on(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("job"):
            ds, op = _grid_call(mesh)
    np.testing.assert_array_equal(ds["VP"], off["VP"])
    ranges = _ranges(prof)
    spans = ("mmt.regular.make_points", "mmt.regular.pull",
             "mmt.regular.assemble")
    for span in spans:
        assert _inside(ranges, span, "job")
        assert not _inside(ranges, span, "mmt.operator.build",
                           *(s for s in spans if s != span))
        assert tprofile._REC.calls[span[4:]] == 1
    counters = tprofile.counter_totals()
    assert counters["regular.points"] == 8**3 == op.n_points
    assert 0 < counters["points.sentinel_rows"] == op.num_missing < 8**3
    assert 0 < counters["ladder.retry.rows"] == op.n_retry
    assert (ds["VP"].ravel()[op.elements.numpy() < 0] == 0).all()


def test_a_point_cloud_inside_the_source_retries_no_row(mesh, monkeypatch):
    _on(monkeypatch)
    nodes = mesh.points.reshape(-1, 3)[::7]  # every row in an element
    res = tlocate.locate(nodes, mesh.points, 4, CFG, fallback="sentinel",
                         device="cpu")
    assert res.n_retry == 0 and bool(res.found.all())
    assert tprofile.counter_totals()["ladder.retry.rows"] == 0
