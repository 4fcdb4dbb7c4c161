"""``multimesh_tpu_torch.utils`` (host numpy, a copy of the JAX package's
``utils.py``; ``greatcircle_points`` is held in
``test_torch_geodesic.py``): the reference's own cases of
``tests/test_utils.py`` run against the port, and every function against
the JAX package's on the same seeded inputs, bit for bit -- both are host
numpy, so any difference is a copying error.
"""
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import config as jconfig  # noqa: E402
from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu import utils as jutils  # noqa: E402
from multimesh_tpu_torch import config as tconfig  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch import utils as tutils  # noqa: E402
from multimesh_tpu_torch.io import exodus as teio  # noqa: E402


def test_config_constants_equal():
    assert tconfig.R_EARTH_M == jconfig.R_EARTH_M
    assert tconfig.PARAM_PRESETS == jconfig.PARAM_PRESETS
    assert callable(tutils.greatcircle_points)


@pytest.mark.parametrize("spec", ["TTI", "ISO", ["A", "B"], "WEIRD",
                                  ("VP",)])
def test_pick_parameters(spec):
    assert tutils.pick_parameters(spec) == jutils.pick_parameters(spec)
    assert tutils.pick_parameters("ISO") == [
        "QKAPPA", "QMU", "RHO", "VP", "VS"]


def test_sph_cart_roundtrip_and_equal(rng):
    col = rng.uniform(0.01, np.pi - 0.01, 100)
    lon = rng.uniform(-np.pi, np.pi, 100)
    rad = rng.uniform(1e5, 7e6, 100)
    xyz = tutils.sph2cart(col, lon, rad)
    for a, b in zip(xyz, jutils.sph2cart(col, lon, rad)):
        np.testing.assert_array_equal(a, b)
    back = tutils.cart2sph(*xyz)
    for a, b in zip(back, jutils.cart2sph(*xyz)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(back[0], col, atol=1e-12)
    np.testing.assert_allclose(back[1], lon, atol=1e-12)
    np.testing.assert_allclose(back[2], rad, rtol=1e-12)
    with pytest.raises(ValueError):
        tutils.sph2cart(np.array([-0.1]), np.array([0.0]), np.array([1.0]))
    c, l, r = tutils.cart2sph(0.0, 0.0, 0.0)
    assert np.isfinite(c) and np.isfinite(l) and r == 0
    np.testing.assert_array_equal(tutils.lat2colat(col), jutils.lat2colat(col))
    np.testing.assert_array_equal(tutils.colat2lat(col), jutils.colat2lat(col))


def test_latlondepth_to_xyz(rng):
    xyz = tutils.latlondepth_to_xyz(np.array([[90.0, 0.0, 0.0]]))
    np.testing.assert_allclose(xyz, [[0, 0, tconfig.R_EARTH_M]], atol=1e-6)
    xyz = tutils.latlondepth_to_xyz(np.array([[0.0, 90.0, 1e6]]))
    np.testing.assert_allclose(xyz, [[0, tconfig.R_EARTH_M - 1e6, 0]],
                               atol=1e-6)
    lld = np.stack([rng.uniform(-90, 90, 64), rng.uniform(-180, 180, 64),
                    rng.uniform(0, 2e6, 64)], -1)
    np.testing.assert_array_equal(tutils.latlondepth_to_xyz(lld),
                                  jutils.latlondepth_to_xyz(lld))


def test_rot_matrix_and_rotate(rng):
    m = tutils.get_rot_matrix(0.7, 1.0, 2.0, -0.5)
    np.testing.assert_array_equal(m, jutils.get_rot_matrix(0.7, 1.0, 2.0,
                                                           -0.5))
    np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.linalg.det(m), 1.0, atol=1e-12)
    mz = tutils.get_rot_matrix(np.pi / 2, 0, 0, 1.0)
    np.testing.assert_allclose(mz @ [1, 0, 0], [0, 1, 0], atol=1e-12)
    x, y, z = rng.normal(size=(3, 20))
    np.testing.assert_array_equal(tutils.rotate(x, y, z, m),
                                  jutils.rotate(x, y, z, m))


def test_rotate_mesh_roundtrip_and_equal(tmp_path):
    mesh = tmt.box_mesh(shape=(2, 2, 2), order=1)
    pt, pj = tmp_path / "rot_t.e", tmp_path / "rot_j.e"
    for p in (pt, pj):
        teio.write_exodus(p, mesh.vertices, mesh.connectivity,
                          {"V": np.zeros(27)})
    orig = teio.Exodus(pt).points.copy()
    event = (0.3, 1.1)  # radians, as in the reference
    rot_t = tutils.rotate_mesh(pt, event)
    rot_j = jutils.rotate_mesh(pj, event)
    np.testing.assert_array_equal(rot_t, rot_j)
    rotated = teio.Exodus(pt).points.copy()
    np.testing.assert_array_equal(rotated, teio.Exodus(pj).points)
    assert not np.allclose(rotated, orig)
    np.testing.assert_allclose(np.linalg.norm(rotated, axis=1),
                               np.linalg.norm(orig, axis=1), atol=1e-12)
    tutils.rotate_mesh(pt, event, backwards=True)
    np.testing.assert_allclose(teio.Exodus(pt).points, orig, atol=1e-12)


def test_load_exodus(tmp_path):
    mesh = tmt.box_mesh(shape=(3, 2, 2), order=1)
    p = tmp_path / "m.e"
    tmt.write_exodus_fixture(p, mesh, parameters=("VP",))
    exo, cent = tutils.load_exodus(p)
    _, cent_j = jutils.load_exodus(p)
    np.testing.assert_array_equal(cent, cent_j)
    np.testing.assert_allclose(
        cent, mesh.vertices[mesh.connectivity].mean(1))
    assert isinstance(tutils.load_exodus(p, find_centroids=False),
                      teio.Exodus)
    assert exo.nelem == mesh.nelem


def _grid():
    lat = np.linspace(-10, 10, 5)
    lon = np.linspace(0, 30, 7)
    depth = np.linspace(0, 1e5, 3)
    ds = tutils.create_dataset_grid(lat, lon, depth)
    ds.data["VP"] = np.arange(3 * 5 * 7, dtype=float).reshape(3, 5, 7)
    return ds, lat, lon, depth


@pytest.mark.parametrize("fmt", ["NETCDF4", "NETCDF3_64BIT",
                                 "NETCDF3_CLASSIC"])
def test_regular_grid_netcdf_both_ways(tmp_path, fmt):
    """Each flavor round-trips through the port, and a file written by
    either package reads identically through the other."""
    import h5py

    ds, lat, lon, depth = _grid()
    p = tmp_path / "grid.nc"
    ds.to_netcdf(p, format=fmt)
    if fmt == "NETCDF4":
        with open(p, "rb") as fh:
            assert fh.read(8) == b"\x89HDF\r\n\x1a\n"
        with h5py.File(p, "r") as f:
            assert f["latitude"].attrs["CLASS"] == b"DIMENSION_SCALE"
            assert f["VP"].dims[0][0] == f["depth"]
            assert f["VP"].dims[1][0] == f["latitude"]
            assert f["VP"].dims[2][0] == f["longitude"]
            assert f["latitude"].attrs["units"] == "deg"
    for reader in (tutils.RegularGridData, jutils.RegularGridData):
        back = reader.from_netcdf(p)
        np.testing.assert_array_equal(back["VP"], ds["VP"])
        np.testing.assert_array_equal(back.lat, lat)
        np.testing.assert_array_equal(back.lon, lon)
        np.testing.assert_array_equal(back.depth, depth)
        assert back.attrs["radius_in_meters"] == tconfig.R_EARTH_M
    pj = tmp_path / "grid_j.nc"
    jds = jutils.create_dataset_grid(lat, lon, depth)
    jds.data["VP"] = ds["VP"]
    jds.to_netcdf(pj, format=fmt)
    np.testing.assert_array_equal(
        tutils.RegularGridData.from_netcdf(pj)["VP"], ds["VP"])
    with pytest.raises(ValueError):
        ds.to_netcdf(p, format="NOPE")


def test_to_xarray_with_stub(monkeypatch):
    """A stub records what to_xarray would hand a real xarray.Dataset
    (dims/coords/attrs layout, reference utils.py:619-646)."""

    class _StubVar:
        def __init__(self):
            self.attrs = {}

    class _StubDataset:
        def __init__(self, data_vars, coords=None, attrs=None):
            self.data_vars = dict(data_vars)
            self.coords = dict(coords or {})
            self.attrs = dict(attrs or {})
            for name in list(self.data_vars) + list(self.coords):
                setattr(self, name, _StubVar())

    xr = types.ModuleType("xarray")
    xr.Dataset = _StubDataset
    monkeypatch.setitem(sys.modules, "xarray", xr)

    ds, _, _, _ = _grid()
    x = ds.to_xarray()
    dims, arr = x.data_vars["VP"]
    assert dims == ["depth", "latitude", "longitude"]
    np.testing.assert_allclose(arr, ds["VP"])
    assert set(x.coords) == {"depth", "latitude", "longitude"}
    assert x.attrs["radius_in_meters"] == tconfig.R_EARTH_M
    assert x.depth.attrs["units"] == "m"
    assert x.latitude.attrs["units"] == "deg"

    md = tutils.MeshDataset(
        data={"VSV": ds["VP"].reshape(15, 7)},
        coords={"x": ds["VP"].reshape(15, 7)},
        gll_order=4, coord_type="cartesian",
    )
    mx = md.to_xarray()
    assert mx.data_vars["VSV"][0] == ["element", "point"]
    assert mx.attrs["gll_order"] == 4


@pytest.mark.parametrize("coords,layers", [("cartesian", "all"),
                                           ("spherical", [1]),
                                           ("cartesian", "nocore")])
def test_create_dataset_equals_jax(tmp_path, coords, layers):
    mesh = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=4, order=2, n_layers=2)
    p = tmp_path / "m.h5"
    tmt.write_salvus_fixture(p, mesh, parameters=("VP", "VS"))
    got = tutils.create_dataset(p, layers=layers, coords=coords)
    want = jutils.create_dataset(p, layers=layers, coords=coords)
    assert got.gll_order == want.gll_order == 2
    assert got.coord_type == coords
    assert list(got.data) == list(want.data) == ["VP", "VS"]
    for k in want.data:
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got.coords) == list(want.coords)
    for k in want.coords:
        np.testing.assert_array_equal(got.coords[k], want.coords[k])
    with pytest.raises(ValueError):
        tutils.create_dataset(p, coords="polar")


def test_fixtures_equal_jax(tmp_path):
    """The Exodus fixture of both packages: equal files' content."""
    mesh_t = tmt.box_mesh(shape=(3, 2, 2), order=1)
    mesh_j = jmt.box_mesh(shape=(3, 2, 2), order=1)
    nt = tmt.write_exodus_fixture(tmp_path / "t.e", mesh_t, ("VP", "RHO"))
    nj = jmt.write_exodus_fixture(tmp_path / "j.e", mesh_j, ("VP", "RHO"))
    for k in nj:
        np.testing.assert_array_equal(nt[k], nj[k])
    assert (tmp_path / "t.e").read_bytes() == (tmp_path / "j.e").read_bytes()
