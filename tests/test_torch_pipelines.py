"""The pipelines of ``multimesh_tpu_torch.engine`` / ``api`` beside
``gll_2_gll``, each on the CPU against the JAX package's on copies of the
same small files (the meshes of the JAX package's engine tests): the
Exodus transfers, the layered GLL -> GLL paths with their
``interp_info.h5`` cache passing between the packages both ways, the
point queries, and each arrays core against its file wrapper.

Tolerances.  The JAX package on the CPU solves in f64; the port's CPU
path runs the f32 plain twins of its kernels, so written values agree to
rtol 2e-6, and to 1e-9 once the port polishes its refs
(``MMT_DF32_POLISH=1``, the twins of K4 and K5).  Which rows take a
fallback (``fixed_ref``, ``best``, sentinel zeros) is identical.
"""
import inspect
import shutil

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import api as japi  # noqa: E402
from multimesh_tpu import engine as jengine  # noqa: E402
from multimesh_tpu.io import exodus as jeio  # noqa: E402
from multimesh_tpu.io import salvus as jsio  # noqa: E402
from multimesh_tpu_torch import TransferOperator as TOp  # noqa: E402
from multimesh_tpu_torch import api as tapi  # noqa: E402
from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch import utils as tutils  # noqa: E402
from multimesh_tpu_torch.config import R_EARTH_M  # noqa: E402
from multimesh_tpu_torch.io import exodus as teio  # noqa: E402
from multimesh_tpu_torch.io import salvus as tsio  # noqa: E402
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402

RTOL = 2e-6  # f32 refs against f64 refs
RTOL_POLISHED = 1e-9


def _nodal(path, name):
    return tsio.SalvusMesh(path, fast_mode=False).element_nodal_fields[name]


def _data(path):
    with h5py.File(path, "r") as f:
        return f["MODEL/data"][()], tsio.read_dim_labels(f["MODEL/data"])


def _copies(tmp_path, path):
    """Two copies of a file, one for each package."""
    return (shutil.copyfile(path, tmp_path / ("t_" + path.name)),
            shutil.copyfile(path, tmp_path / ("j_" + path.name)))


# -- the facade -------------------------------------------------------------
NON_PLOTTING = ["query_model", "exodus_2_gll", "gll_2_gll",
                "gll_2_gll_layered", "gll_2_gll_layered_multi",
                "gll_2_gll_layered_multi_two", "gll_2_exodus",
                "interpolate_to_points", "interpolate_to_mesh",
                "extract_regular_grid"]


@pytest.mark.parametrize("name", NON_PLOTTING)
def test_api_entry_has_the_jax_arguments_plus_device(name):
    j = inspect.signature(getattr(japi, name)).parameters
    t = inspect.signature(getattr(tapi, name)).parameters
    assert list(t) == list(j) + ["device"]
    assert all(t[k].default == j[k].default for k in j)
    assert t["device"].default is None


def test_engine_has_every_function_of_the_jax_engine():
    for name, fn in inspect.getmembers(jengine, inspect.isfunction):
        if fn.__module__ != jengine.__name__:
            continue
        assert hasattr(tengine, name), name
        if name.startswith("_"):
            continue
        j = inspect.signature(fn).parameters
        t = inspect.signature(getattr(tengine, name)).parameters
        assert list(t) == list(j) + ["device"], name
        # (the two LocateConfig classes are copies: compared by repr)
        assert all(repr(t[k].default) == repr(j[k].default)
                   for k in j), name


# -- Exodus <-> GLL -----------------------------------------------------------
@pytest.fixture(scope="module")
def exo_gll(tmp_path_factory):
    """An order-1 Exodus source with the smooth field and a pristine
    order-2 GLL target (zeros: a target left unwritten cannot pass)."""
    d = tmp_path_factory.mktemp("exo_gll")
    exo_mesh = tmt.shell_mesh(n_lat=8, n_lon=8, n_rad=6, order=1)
    gll_mesh = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=2,
                              r_inner=3.7e6, r_outer=6.2e6,
                              lat_extent=(0.58, 1.12),
                              lon_extent=(0.38, 1.32))
    params = ("VP", "VS", "RHO")
    tmt.write_exodus_fixture(d / "src.e", exo_mesh, parameters=params)
    tmt.write_salvus_fixture(d / "gll.h5", gll_mesh, parameters=params,
                             field_kind="linear")
    return exo_mesh, gll_mesh, d / "src.e", d / "gll.h5", list(params)


def test_exodus_2_gll_and_back_match_jax(exo_gll, tmp_path):
    exo_mesh, gll_mesh, exo_path, gll_path, params = exo_gll
    t_gll, j_gll = _copies(tmp_path, gll_path)
    tapi.exodus_2_gll(mesh=str(exo_path), gll_model=str(t_gll),
                      parameters=params, device="cpu")
    japi.exodus_2_gll(mesh=str(exo_path), gll_model=str(j_gll),
                      parameters=params)
    got, labels = _data(t_gll)
    want, jlabels = _data(j_gll)
    assert labels == jlabels == params
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # both packages round the result to f32 before the write, and locate
    # the f32-rounded target coordinates: the written f64 values are
    # exactly f32 numbers, and a trilinear source's discretisation error
    # (here ~1e-3) is far above either rounding
    np.testing.assert_array_equal(got, got.astype(np.float32))
    np.testing.assert_array_equal(want, want.astype(np.float32))
    truth = tmt.smooth_field(gll_mesh.points)
    for i in range(3):
        rel = np.abs(got[:, i] / (1 + 0.1 * i) - truth) / np.abs(truth)
        assert rel.max() < 5e-3

    # back: the transferred GLL model onto the nodes of another Exodus mesh
    back = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=3, order=1,
                          r_inner=3.9e6, r_outer=6.0e6,
                          lat_extent=(0.65, 1.05), lon_extent=(0.5, 1.2))
    tmt.write_exodus_fixture(tmp_path / "back.e", back, parameters=("VP",),
                             field_kind="linear")
    t_e, j_e = _copies(tmp_path, tmp_path / "back.e")
    vals = tapi.gll_2_exodus(gll_model=str(t_gll), exodus_model=str(t_e),
                             device="cpu")
    jvals = japi.gll_2_exodus(gll_model=str(t_gll), exodus_model=str(j_e))
    assert isinstance(vals, np.ndarray) and vals.shape == (back.vertices.shape[0], 3)
    np.testing.assert_allclose(vals, np.asarray(jvals), rtol=RTOL)
    a, b = teio.Exodus(t_e), jeio.Exodus(j_e)
    assert a.nodal_parameters == b.nodal_parameters == ["VP", "VS", "RHO"]
    # the arrays core gives what the wrapper attached
    with h5py.File(t_gll, "r") as f:
        core = tengine.gll_2_points_arrays(
            f["MODEL/coordinates"][()], f["MODEL/data"][()], a.points,
            device="cpu")
    np.testing.assert_array_equal(core.numpy(), vals)
    for i, p in enumerate(params):  # VS and RHO were declared on the fly
        np.testing.assert_array_equal(a.get_nodal_field(p), vals[:, i])
        np.testing.assert_allclose(a.get_nodal_field(p),
                                   b.get_nodal_field(p), rtol=RTOL)


def test_exodus_2_gll_arrays_core_equals_the_file_wrapper(exo_gll,
                                                          tmp_path):
    """The arrays core with a numpy sink writes what the wrapper writes
    into the file."""
    _, gll_mesh, exo_path, gll_path, params = exo_gll
    t_gll, _ = _copies(tmp_path, gll_path)
    tapi.exodus_2_gll(mesh=str(exo_path), gll_model=str(t_gll),
                      parameters=params, device="cpu")
    exo = teio.Exodus(exo_path)
    conn = exo.canonical_connectivity()
    fields = np.stack([exo.get_nodal_field(p)[conn] for p in params])
    coords = gll_mesh.points.astype(np.float32)
    sinks = []

    def open_sink(names):
        assert names == params
        sinks.append(np.zeros((gll_mesh.nelem, 3, 27), np.float32))
        return sinks[0]

    assert tengine.exodus_2_gll_arrays(
        exo.canonical_corner_nodes(), fields, params, coords, open_sink,
        device="cpu") is None
    np.testing.assert_array_equal(sinks[0].astype(np.float64),
                                  _data(t_gll)[0])
    # small blocks: several pulls, the same rows
    out = np.zeros_like(sinks[0])
    tengine._stream_pull_write(out, torch.as_tensor(sinks[0]),
                               block_bytes=1000)
    np.testing.assert_array_equal(out, sinks[0])


def test_exodus_pipelines_raise_on_missing(exo_gll, tmp_path):
    exo_mesh, _, exo_path, gll_path, params = exo_gll
    t_gll, _ = _copies(tmp_path, gll_path)
    with pytest.raises(ValueError, match="lacks nodal parameters"):
        tapi.exodus_2_gll(mesh=str(exo_path), gll_model=str(t_gll),
                          parameters=["NOPE"], device="cpu")
    far = tmt.shell_mesh(n_lat=2, n_lon=2, n_rad=2, order=1,
                         r_inner=7.0e6, r_outer=8.0e6)
    tmt.write_exodus_fixture(tmp_path / "far.e", far, parameters=("VP",))
    before = (tmp_path / "far.e").read_bytes()
    with pytest.raises(RuntimeError, match="could not be interpolated"):
        tengine.exodus_2_exodus(str(exo_path), str(tmp_path / "far.e"),
                                parameters=["VP"], device="cpu")
    assert (tmp_path / "far.e").read_bytes() == before  # nothing written
    with pytest.raises(ValueError, match="lacks nodal parameters"):
        tengine.exodus_2_exodus(str(exo_path), str(tmp_path / "far.e"),
                                parameters=["NOPE"], device="cpu")


def _e2e_pair(tmp_path, dim):
    if dim == 2:
        src = tmt.box_mesh(shape=(12, 12), order=1)
        tgt = tmt.box_mesh(shape=(9, 9), order=1,
                           extent=[(0.05, 0.95), (0.05, 0.95)])
    else:
        src = tmt.shell_mesh(n_lat=10, n_lon=10, n_rad=8, order=1)
        tgt = tmt.shell_mesh(n_lat=7, n_lon=7, n_rad=6, order=1,
                             r_inner=3.7e6, r_outer=6.2e6,
                             lat_extent=(0.55, 1.15),
                             lon_extent=(0.35, 1.35))
    tmt.write_exodus_fixture(tmp_path / "a.e", src, parameters=("VP", "VS"))
    tmt.write_exodus_fixture(tmp_path / "b.e", tgt, parameters=("VP", "VS"),
                             field_kind="linear")
    return src, tgt


@pytest.mark.parametrize("dim", [2, 3])
def test_exodus_2_exodus_matches_jax(tmp_path, dim):
    """QUAD4 -> QUAD4 and HEX8 -> HEX8.  A target node on a source face is
    accepted by two elements: values are compared, not element ids."""
    src, tgt = _e2e_pair(tmp_path, dim)
    t_b, j_b = _copies(tmp_path, tmp_path / "b.e")
    tengine.exodus_2_exodus(str(tmp_path / "a.e"), str(t_b),
                            parameters=["VP", "VS"], device="cpu")
    jengine.exodus_2_exodus(str(tmp_path / "a.e"), str(j_b),
                            parameters=["VP", "VS"])
    for i, p in enumerate(("VP", "VS")):
        got = teio.Exodus(t_b).get_nodal_field(p)
        np.testing.assert_allclose(got, jeio.Exodus(j_b).get_nodal_field(p),
                                   rtol=RTOL)
        truth = tmt.smooth_field(tgt.vertices) * (1 + 0.1 * i)
        assert np.max(np.abs(got - truth) / np.abs(truth)) < 5e-3


def test_exodus_2_exodus_polished_matches_jax_f64(tmp_path, monkeypatch):
    src, tgt = _e2e_pair(tmp_path, 3)
    t_b, j_b = _copies(tmp_path, tmp_path / "b.e")
    jengine.exodus_2_exodus(str(tmp_path / "a.e"), str(j_b),
                            parameters=["VP"])
    monkeypatch.setenv("MMT_DF32_POLISH", "1")
    tengine.exodus_2_exodus(str(tmp_path / "a.e"), str(t_b),
                            parameters=["VP"], device="cpu")
    np.testing.assert_allclose(teio.Exodus(t_b).get_nodal_field("VP"),
                               jeio.Exodus(j_b).get_nodal_field("VP"),
                               rtol=RTOL_POLISHED)


# -- layered ------------------------------------------------------------------
@pytest.fixture(scope="module")
def layered(tmp_path_factory):
    d = tmp_path_factory.mktemp("layered")
    src = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=4, order=2, n_layers=2)
    tgt = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=4, order=2, n_layers=2,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
    tmt.write_salvus_fixture(d / "s.h5", src, parameters=("VP", "VS"))
    tmt.write_salvus_fixture(d / "t.h5", tgt, parameters=("VP", "VS"),
                             field_kind="linear")
    return src, tgt, d / "s.h5", d / "t.h5"


LAYERED = {
    "layered": ("gll_2_gll_layered", dict(layers="all",
                                          parameters=["VP", "VS"])),
    "multi": ("gll_2_gll_layered_multi", dict(layers="all",
                                              parameters=["VP", "VS"],
                                              threads=3)),
    "multi_two": ("gll_2_gll_layered_multi_two",
                  dict(layers="all", parameters=["VP", "VS"])),
}


@pytest.mark.parametrize("entry", list(LAYERED))
def test_layered_entry_matches_jax(layered, tmp_path, entry):
    src, tgt, sp, tp = layered
    name, kw = LAYERED[entry]
    t_t, j_t = _copies(tmp_path, tp)
    getattr(tapi, name)(from_gll=str(sp), to_gll=str(t_t), device="cpu",
                        **kw)
    getattr(japi, name)(from_gll=str(sp), to_gll=str(j_t), **kw)
    truth = tmt.smooth_field(tgt.points)
    for i, p in enumerate(("VP", "VS")):
        got = _nodal(t_t, p)
        np.testing.assert_allclose(got, _nodal(j_t, p), rtol=RTOL)
        assert np.max(np.abs(got / (1 + 0.1 * i) - truth)) < 2e-2
    # the rest of the file is as it was
    np.testing.assert_array_equal(_nodal(t_t, "z_node_1D"),
                                  _nodal(tp, "z_node_1D"))


def test_layered_polished_matches_jax_f64(layered, tmp_path, monkeypatch):
    _, _, sp, tp = layered
    t_t, j_t = _copies(tmp_path, tp)
    japi.gll_2_gll_layered(from_gll=str(sp), to_gll=str(j_t), layers="all",
                           parameters=["VP"])
    monkeypatch.setenv("MMT_DF32_POLISH", "1")
    tapi.gll_2_gll_layered(from_gll=str(sp), to_gll=str(t_t), layers="all",
                           parameters=["VP"], device="cpu")
    np.testing.assert_allclose(_nodal(t_t, "VP"), _nodal(j_t, "VP"),
                               rtol=RTOL_POLISHED)


def _poison(cache):
    with h5py.File(cache / "interp_info.h5", "r+") as f:
        for layer in list(f["coeffs"]):
            f[f"coeffs/{layer}"][...] = 2.0 * f[f"coeffs/{layer}"][()]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_layered_cache_passes_between_the_packages(layered, tmp_path,
                                                   writer):
    """interp_info.h5 written by one package is served by the other for
    the same two files -- proven served by doubling the stored
    coefficients: the other package's output doubles."""
    _, _, sp, tp = layered
    cache = tmp_path / "cache"
    kw = dict(from_gll=str(sp), layers="all", parameters=["VP", "VS"],
              stored_array=str(cache))
    first, second = _copies(tmp_path, tp)
    if writer == "torch":
        tapi.gll_2_gll_layered(to_gll=str(first), device="cpu", **kw)
    else:
        japi.gll_2_gll_layered(to_gll=str(first), **kw)
    got = _nodal(first, "VP")
    with h5py.File(cache / "interp_info.h5", "r") as f:
        assert sorted(f["coeffs"]) == sorted(f["elements"]) == ["1", "2"]
        assert f.attrs["fingerprint"].dtype == np.uint64
        assert "fixed_ref" in str(f.attrs["semantics"])
        assert f["elements/1"].dtype == np.int32
        # f32 coefficients from the port's f32 refs, f64 from the JAX
        # CPU tier's
        assert f["coeffs/1"].dtype == (
            np.float32 if writer == "torch" else np.float64)
    _poison(cache)
    if writer == "torch":
        japi.gll_2_gll_layered_multi(to_gll=str(second), threads=2, **kw)
        rtol = 1e-6  # stored f32 coefficients, applied in f32
    else:
        tapi.gll_2_gll_layered_multi(to_gll=str(second), threads=2,
                                     device="cpu", **kw)
        rtol = 1e-12
    np.testing.assert_allclose(_nodal(second, "VP"), 2.0 * got, rtol=rtol)


def test_layered_cache_of_the_polished_path_is_f64(layered, tmp_path,
                                                   monkeypatch):
    _, _, sp, tp = layered
    cache = tmp_path / "cache"
    t_t, again = _copies(tmp_path, tp)
    monkeypatch.setenv("MMT_DF32_POLISH", "1")
    kw = dict(from_gll=str(sp), layers="all", parameters=["VP"],
              stored_array=str(cache), device="cpu")
    tapi.gll_2_gll_layered(to_gll=str(t_t), **kw)
    with h5py.File(cache / "interp_info.h5", "r") as f:
        assert f["coeffs/2"].dtype == np.float64
    tapi.gll_2_gll_layered(to_gll=str(again), **kw)  # served: no refs
    np.testing.assert_allclose(_nodal(again, "VP"), _nodal(t_t, "VP"),
                               rtol=1e-12)


@pytest.mark.parametrize("why", ["geometry", "semantics", "layers"])
def test_layered_cache_is_rejected(layered, tmp_path, capsys, why):
    """A cache of other geometry, other locate semantics or fewer layers
    is ignored with a notice and rebuilt, never served: poisoned, it
    would double the output."""
    src, tgt, sp, tp = layered
    cache = tmp_path / "cache"
    first, second = _copies(tmp_path, tp)
    kw = dict(from_gll=str(sp), parameters=["VP"], stored_array=str(cache))
    japi.gll_2_gll_layered(to_gll=str(first),
                           layers=[2] if why == "layers" else "all", **kw)
    _poison(cache)
    capsys.readouterr()
    if why == "geometry":
        other = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=4, order=2,
                               n_layers=2, lat_extent=(0.6, 1.1),
                               lon_extent=(0.4, 1.3))
        tmt.write_salvus_fixture(second, other, parameters=("VP", "VS"),
                                 field_kind="linear")
        tgt = other
        tapi.gll_2_gll_layered(to_gll=str(second), layers="all",
                               device="cpu", **kw)
        note = "different geometry"
    elif why == "semantics":
        tapi.gll_2_gll_layered_multi_two(to_gll=str(second), layers="all",
                                         device="cpu", **kw)
        note = "different locate semantics"
    else:
        tapi.gll_2_gll_layered(to_gll=str(second), layers="all",
                               device="cpu", **kw)
        note = "does not cover the requested layers"
    assert note in capsys.readouterr().out
    truth = tmt.smooth_field(tgt.points)
    assert np.max(np.abs(_nodal(second, "VP") - truth)) < 2e-2
    with h5py.File(cache / "interp_info.h5", "r") as f:
        sem = f.attrs["semantics"]
        assert sorted(f["coeffs"]) == ["1", "2"]
    assert ("snap" in str(sem)) == (why == "semantics")


def test_layered_parameters_all_with_fast_mode_mesh(layered, tmp_path):
    """A user-built SalvusMesh is fast_mode=True (fields lazy);
    parameters="all" must still expand to the real field list."""
    _, tgt, sp, tp = layered
    t_t, j_t = _copies(tmp_path, tp)
    m = tsio.SalvusMesh(sp)
    assert m.element_nodal_fields == {}
    tapi.gll_2_gll_layered(from_gll=m, to_gll=str(t_t), layers="all",
                           parameters="all", device="cpu")
    japi.gll_2_gll_layered(from_gll=jsio.SalvusMesh(sp), to_gll=str(j_t),
                           layers="all", parameters="all")
    for p in ("VP", "VS"):
        np.testing.assert_allclose(_nodal(t_t, p), _nodal(j_t, p),
                                   rtol=RTOL)
    assert np.max(np.abs(_nodal(t_t, "VP")
                         - tmt.smooth_field(tgt.points))) < 2e-2


def test_interpolate_to_points_layered_matches_jax(tmp_path, capsys):
    """Sentinel semantics: the nodes beyond the source are zero, the same
    nodes in both packages; the located ones carry the source's values."""
    src = tmt.shell_mesh(n_lat=5, n_lon=5, n_rad=4, order=2, n_layers=2)
    src_mid = 0.5 * (3.48e6 + 6.371e6)
    r_outer = 6.9e6
    tgt = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=4, order=2, n_layers=2,
                         r_inner=2 * src_mid - r_outer, r_outer=r_outer,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
    tmt.write_salvus_fixture(tmp_path / "s.h5", src, parameters=("VP", "VS"))
    tmt.write_salvus_fixture(tmp_path / "t.h5", tgt, parameters=("VP", "VS"))
    t_t, j_t = _copies(tmp_path, tmp_path / "t.h5")
    capsys.readouterr()
    tengine.interpolate_to_points_layered(
        str(tmp_path / "s.h5"), str(t_t), parameters=["VP"], layers="all",
        device="cpu")
    assert "points could not be interpolated" in capsys.readouterr().out
    jengine.interpolate_to_points_layered(
        str(tmp_path / "s.h5"), str(j_t), parameters=["VP"], layers="all")
    got, want = _nodal(t_t, "VP"), _nodal(j_t, "VP")
    np.testing.assert_array_equal(got == 0.0, want == 0.0)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    r = np.linalg.norm(tgt.points, axis=-1)
    outside = (r > 6.371e6 * 1.02) | (r < 3.48e6 * 0.98)
    assert outside.any() and (got[outside] == 0).all()
    interior = (r < 6.371e6 * 0.98) & (r > 3.48e6 * 1.02)
    assert interior.any() and (got[interior] != 0).all()
    truth = tmt.smooth_field(tgt.points)
    assert np.max(np.abs(got[interior] - truth[interior])) < 2e-2


# -- point queries ----------------------------------------------------------
@pytest.fixture(scope="module")
def globe(tmp_path_factory):
    d = tmp_path_factory.mktemp("globe")
    mesh = tmt.shell_mesh(n_lat=6, n_lon=12, n_rad=3, order=2,
                          r_inner=5.0e6, r_outer=6.371e6,
                          lat_extent=(0.2, 2.9), lon_extent=(-3.1, 3.1))
    tmt.write_salvus_fixture(d / "m.h5", mesh, parameters=("VP", "VS"))
    rng = np.random.default_rng(0)
    lld = np.stack([rng.uniform(-70, 70, 80), rng.uniform(-170, 170, 80),
                    rng.uniform(1e5, 1.2e6, 80)], -1)
    return mesh, d / "m.h5", lld


def test_query_model_matches_jax_and_its_arrays_core(globe):
    mesh, path, lld = globe
    vals = tapi.query_model(coordinates=lld, model=str(path), device="cpu")
    assert torch.is_tensor(vals) and vals.shape == (80, 3)
    want = np.asarray(japi.query_model(coordinates=lld, model=str(path)))
    np.testing.assert_allclose(vals.numpy(), want, rtol=RTOL)
    truth = tmt.smooth_field(tutils.latlondepth_to_xyz(lld))
    np.testing.assert_allclose(vals.numpy()[:, 0], truth, atol=5e-2)
    pts, data, params = tsio.load_hdf5_params(path)
    assert params == ["VP", "VS", "z_node_1D"]
    core = tengine.gll_2_points_arrays(
        pts, data, tutils.latlondepth_to_xyz(lld), device="cpu")
    assert torch.equal(core, vals)
    with pytest.raises(ValueError, match="lat lon depth"):
        tengine.query_model(lld[:, :2], str(path), device="cpu")


def test_query_model_polished_matches_jax_f64(globe, monkeypatch):
    _, path, lld = globe
    want = np.asarray(japi.query_model(coordinates=lld, model=str(path)))
    monkeypatch.setenv("MMT_DF32_POLISH", "1")
    vals = tapi.query_model(coordinates=lld, model=str(path), device="cpu")
    assert vals.dtype == torch.float64
    np.testing.assert_allclose(vals.numpy(), want, rtol=RTOL_POLISHED)


def test_interpolate_to_points_3d_with_points_outside(globe, capsys):
    """Geocentric input, a quarter of the points above the surface: those
    rows are zero in both packages, with the reference's notice."""
    _, path, lld = globe
    lld = lld.copy()
    lld[:20, 2] = -4.0e5  # above the surface
    capsys.readouterr()
    vals = tapi.interpolate_to_points(mesh=str(path), points=lld,
                                      params_to_interp=["VS", "VP"],
                                      geocentric=True, device="cpu")
    out = capsys.readouterr().out
    assert "20 points could not find an enclosing element" in out
    want = np.asarray(japi.interpolate_to_points(
        mesh=str(path), points=lld, params_to_interp=["VS", "VP"],
        geocentric=True))
    got = vals.numpy()
    assert (got[:20] == 0).all() and (want[:20] == 0).all()
    assert (got[20:] != 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    truth = tmt.smooth_field(tutils.latlondepth_to_xyz(lld[20:]))
    np.testing.assert_allclose(got[20:, 0], truth * 1.1, atol=6e-2)


def test_interpolate_to_points_2d_with_points_outside(tmp_path):
    src = tmt.box_mesh(shape=(6, 6), order=4, warp=0.05)
    path = tmp_path / "src2d.h5"
    tmt.write_salvus_fixture(path, src, parameters=("VP",))
    rng = np.random.default_rng(1234)
    pts = rng.uniform(0.05, 0.95, size=(300, 2))
    pts[:30] += 2.0
    vals = tengine.interpolate_to_points(str(path), pts, ["VP"],
                                         device="cpu").numpy()
    want = np.asarray(jengine.interpolate_to_points(str(path), pts, ["VP"]))
    assert (vals[:30] == 0).all() and (want[:30] == 0).all()
    np.testing.assert_allclose(vals, want, rtol=RTOL)


def _duck_pair():
    src = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=2, order=2)
    tgt = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=2,
                         r_inner=3.6e6, r_outer=6.3e6,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))

    class Duck:
        """Element-nodal points and a fields dict, no file; squeezed in z
        so that the sphere mapping really moves the nodes."""

        def __init__(self, mesh):
            self.element_nodal_fields = {
                "VP": tmt.element_nodal_field(mesh, "smooth"),
                "z_node_1D": np.linalg.norm(mesh.points, axis=-1)
                / R_EARTH_M,
            }
            self.points = mesh.points * np.array([1.0, 1.0, 0.995])

    return src, tgt, Duck


def test_interpolate_to_mesh_files_match_jax(tmp_path):
    src, tgt, _ = _duck_pair()
    tmt.write_salvus_fixture(tmp_path / "s.h5", src, parameters=("VP", "VS"))
    tmt.write_salvus_fixture(tmp_path / "t.h5", tgt, parameters=("VP", "VS"),
                             field_kind="linear")
    t_t, j_t = _copies(tmp_path, tmp_path / "t.h5")
    tapi.interpolate_to_mesh(str(tmp_path / "s.h5"), str(t_t),
                             params_to_interp=["VP"], device="cpu")
    japi.interpolate_to_mesh(str(tmp_path / "s.h5"), str(j_t),
                             params_to_interp=["VP"])
    got = _nodal(t_t, "VP")
    np.testing.assert_allclose(got, _nodal(j_t, "VP"), rtol=RTOL)
    assert np.max(np.abs(got - tmt.smooth_field(tgt.points))) < 2e-2
    with h5py.File(t_t, "r") as f:  # the file's geometry is untouched
        np.testing.assert_array_equal(f["MODEL/coordinates"][()],
                                      tgt.points)


def test_interpolate_to_mesh_duck_objects_geometry_restored():
    src, tgt, Duck = _duck_pair()
    old, new = Duck(src), Duck(tgt)
    jold, jnew = Duck(src), Duck(tgt)
    for m in (new, jnew):
        m.element_nodal_fields["VP"] = np.zeros(tgt.points.shape[:2])
    before_old, before_new = old.points.copy(), new.points.copy()
    tapi.interpolate_to_mesh(old, new, params_to_interp=["VP"],
                             device="cpu")
    japi.interpolate_to_mesh(jold, jnew, params_to_interp=["VP"])
    np.testing.assert_array_equal(old.points, before_old)
    np.testing.assert_array_equal(new.points, before_new)
    got = new.element_nodal_fields["VP"]
    np.testing.assert_allclose(got, jnew.element_nodal_fields["VP"],
                               rtol=RTOL)
    assert np.max(np.abs(got - tmt.smooth_field(tgt.points))) < 2e-2


def test_in_place_geometry_never_serves_a_stale_prep():
    """``interpolate_to_mesh`` maps both meshes to spheres in place and
    restores them.  A plain transfer on the same objects before, between
    and after must see the geometry the arrays hold at that moment: the
    per-mesh prep and the grid index are cached by content, so neither
    the mapped nor the restored state may be served for the other."""
    src, tgt, Duck = _duck_pair()
    old, new = Duck(src), Duck(tgt)
    new.element_nodal_fields["VP"] = np.zeros(tgt.points.shape[:2])
    field = old.element_nodal_fields["VP"]
    flat = new.points.reshape(-1, 3).copy()

    def plain_transfer():
        op = TOp.build(old.points, flat, 2, fallback="snap", device="cpu")
        return op.apply(field).numpy(), op

    tloc._PREP_CACHE.clear()
    first, op1 = plain_transfer()
    tapi.interpolate_to_mesh(old, new, params_to_interp=["VP"],
                             device="cpu")
    second, op2 = plain_transfer()
    np.testing.assert_array_equal(second, first)
    assert torch.equal(op1.refs, op2.refs)
    # and a fresh cache gives the same: the cached prep was the right one
    tloc._PREP_CACHE.clear()
    third, _ = plain_transfer()
    np.testing.assert_array_equal(third, first)
    # the sphere-mapped state differs, and it too is prepared as it is
    from multimesh_tpu_torch.ops import map_to_sphere

    keep = old.points.copy()
    map_to_sphere(old)
    assert not np.allclose(old.points, keep, rtol=1e-4)
    mapped, _ = plain_transfer()
    tloc._PREP_CACHE.clear()
    mapped_fresh, _ = plain_transfer()
    np.testing.assert_array_equal(mapped, mapped_fresh)
    assert not np.allclose(mapped, first, rtol=1e-5)
    old.points[...] = keep
    np.testing.assert_array_equal(plain_transfer()[0], first)
    # a frozen lattice cannot be mapped in place: it raises, it does not
    # serve stale geometry
    old.points.setflags(write=False)
    with pytest.raises(ValueError):
        map_to_sphere(old)


def test_extract_regular_grid_matches_jax(tmp_path, monkeypatch):
    """The grid overhangs the mesh in depth: the rows outside are zero."""
    import sys

    mesh = tmt.shell_mesh(n_lat=6, n_lon=12, n_rad=2, order=2,
                          r_inner=5.5e6, r_outer=6.371e6,
                          lat_extent=(0.2, 2.9), lon_extent=(-3.1, 3.1))
    path = tmp_path / "m.h5"
    tmt.write_salvus_fixture(path, mesh, parameters=("VP", "VS"))
    kw = dict(mesh=str(path), parameters=["VP", "VS"],
              lat_extent=(-60, 60, 7), lon_extent=(-150, 150, 9),
              depth_extent=(-2.0e5, 5e5, 4))
    assert "xarray" not in sys.modules
    ds = tapi.extract_regular_grid(device="cpu", **kw)
    want = japi.extract_regular_grid(**kw)
    assert isinstance(ds, tutils.RegularGridData)
    assert ds["VP"].shape == (4, 7, 9)
    for p in ("VP", "VS"):
        np.testing.assert_allclose(ds[p], want[p], rtol=RTOL)
        np.testing.assert_array_equal(ds[p] == 0, want[p] == 0)
    assert (ds["VP"][0] == 0).all() and (ds["VP"][1:] != 0).all()
    for a, b in ((ds.lat, want.lat), (ds.lon, want.lon),
                 (ds.depth, want.depth)):
        np.testing.assert_array_equal(a, b)
    dep_g, lat_g, lon_g = np.meshgrid(ds.depth, ds.lat, ds.lon,
                                      indexing="ij")
    lld = np.stack([lat_g.ravel(), lon_g.ravel(), dep_g.ravel()], -1)
    truth = tmt.smooth_field(tutils.latlondepth_to_xyz(lld)).reshape(4, 7, 9)
    np.testing.assert_allclose(ds["VP"][1:], truth[1:], rtol=2e-2)

    nc = tmp_path / "grid.nc"
    assert tapi.extract_regular_grid(save_to_netcdf=True,
                                     netcdf_path=str(nc), device="cpu",
                                     **kw) is None
    np.testing.assert_array_equal(
        tutils.RegularGridData.from_netcdf(nc)["VP"], ds["VP"])
    with pytest.raises(ValueError, match="netcdf_path"):
        tapi.extract_regular_grid(save_to_netcdf=True, device="cpu", **kw)
    # with an importable xarray the result goes through to_xarray()
    sentinel = object()
    monkeypatch.setitem(sys.modules, "xarray", type(sys)("xarray"))
    monkeypatch.setattr(tutils.RegularGridData, "to_xarray",
                        lambda self: sentinel)
    assert tapi.extract_regular_grid(device="cpu", **kw) is sentinel


def test_as_salvus_accepts_paths_objects_and_flat_meshes(tmp_path):
    mesh = tmt.box_mesh(shape=(2, 2, 2), order=1)
    tmt.write_salvus_fixture(tmp_path / "m.h5", mesh, parameters=("VP",))
    sm = tengine._as_salvus(tmp_path / "m.h5")
    assert isinstance(sm, tsio.SalvusMesh)
    assert tengine._as_salvus(sm) is sm
    import types

    flat = types.SimpleNamespace(points=mesh.vertices,
                                 connectivity=mesh.connectivity,
                                 element_nodal_fields={"VP": 1})
    duck = tengine._as_salvus(flat)
    assert (duck.nelem, duck.n_gll_points, duck.dimensions,
            duck.shape_order) == (8, 8, 3, 1)
    np.testing.assert_array_equal(duck.points, mesh.points)
    assert tengine._nodal_fields(duck) == {"VP": 1}
    duck.attach_field("VS", [1.0])
    assert "VS" in flat.element_nodal_fields
    with pytest.raises(AttributeError):
        duck.get_elemental_fields()
    assert tengine._as_salvus(7) == 7
