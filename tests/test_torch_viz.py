"""``multimesh_tpu_torch.viz`` and the three plotting ``api`` entries
against the JAX package's, on the CPU (Agg backend, no cartopy).

The helpers are copies, so they are held bit for bit; the two plots put
the same sampling through each package's ``interpolate_to_points`` (the
port's on ``device="cpu"``, its plain twins), so their figures' mesh
arrays are held to the interpolated values' 1e-6 relative: the depth
slice's values element by element, the cross section's values element by
element and its percent deviations, 100 (v / mean - 1), to the 2e-4
percentage points that 1e-6 in v and the mean allows.
"""
import inspect
import subprocess
import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import api as japi  # noqa: E402
from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.viz import plotter as jplotter  # noqa: E402
from multimesh_tpu.viz import colormaps as jcmaps  # noqa: E402
from multimesh_tpu_torch import api as tapi  # noqa: E402
from multimesh_tpu_torch import viz as tviz  # noqa: E402
from multimesh_tpu_torch.viz import colormaps as tcmaps  # noqa: E402
from multimesh_tpu_torch.viz import plotter as tplotter  # noqa: E402

PLOTTING = ["plot_depth_slice", "plot_cross_section", "find_good_projection"]


@pytest.fixture(scope="module")
def global_mesh(tmp_path_factory):
    """The JAX package's viz fixture: a near-global order-2 shell with
    VSV and VSH, as a Salvus file."""
    tmp = tmp_path_factory.mktemp("tviz")
    mesh = jmt.shell_mesh(n_lat=8, n_lon=16, n_rad=2, order=2,
                          r_inner=3.0e6, r_outer=6.371e6,
                          lat_extent=(0.05, 3.09),
                          lon_extent=(-3.14, 3.14))
    path = tmp / "m.h5"
    jmt.write_salvus_fixture(path, mesh, parameters=("VSV", "VSH"))
    return str(path)


@pytest.mark.parametrize("name", PLOTTING)
def test_api_entry_has_the_jax_arguments_plus_device(name):
    j = inspect.signature(getattr(japi, name)).parameters
    t = inspect.signature(getattr(tapi, name)).parameters
    assert list(t) == list(j) + ["device"]
    assert all(t[k].default == j[k].default for k in j)
    assert t["device"].default is None


def test_api_has_all_thirteen_entries():
    public = {n for n, f in inspect.getmembers(japi, inspect.isfunction)
              if f.__module__ == japi.__name__ and not n.startswith("_")}
    assert len(public) == 13
    for name in public:
        t = inspect.signature(getattr(tapi, name)).parameters
        assert list(t)[-1] == "device", name


@pytest.mark.parametrize("name", ["roma", "roma_r"])
def test_colormaps_equal(name):
    x = np.linspace(0, 1, 257)
    np.testing.assert_array_equal(getattr(tcmaps, name)(x),
                                  getattr(jcmaps, name)(x))
    assert getattr(tviz, name) is getattr(tcmaps, name)


@pytest.mark.parametrize("cmap,reverse", [("roma", False), ("roma", True),
                                          ("roma_r", True), ("viridis", False),
                                          ("chroma", False), ("fusion", True)])
def test_get_colormap_equal(cmap, reverse):
    x = np.linspace(0, 1, 33)
    got = tcmaps.get_colormap(cmap, reverse)
    np.testing.assert_array_equal(got(x), jcmaps.get_colormap(cmap,
                                                              reverse)(x))
    assert tcmaps.get_colormap(got) is got


def test_latitude_correction_and_separation_equal():
    lats = np.linspace(-90, 90, 37)
    for la in lats:
        assert (tplotter.elliptic_to_geocentric_latitude(la)
                == jplotter.elliptic_to_geocentric_latitude(la))
    assert -0.22 < tplotter.elliptic_to_geocentric_latitude(45.0) - 45 < -0.15
    rng = np.random.default_rng(5)
    for a in rng.uniform(-90, 90, (20, 4)):
        assert (tplotter.locations2degrees(*a)
                == jplotter.locations2degrees(*a))
    assert abs(tplotter.locations2degrees(90, 0, -90, 0) - 180.0) < 1e-9


def test_create_projection_without_cartopy():
    """Without cartopy (this image) no projection: None, as the JAX
    package gives."""
    try:
        import cartopy  # noqa: F401
    except ImportError:
        assert tapi.find_good_projection(lat_extent=(-90, 90)) is None
        assert tplotter.create_projection("Mollweide") is None
        assert jplotter.create_projection("Mollweide") is None
    else:  # pragma: no cover - not in this image
        pytest.skip("cartopy installed")


def test_sampling_helpers_equal_jax():
    got = tplotter._create_depthslice(500e3, 7, (-10, 30), (5, 60))
    want = jplotter._create_depthslice(500e3, 7, (-10, 30), (5, 60))
    np.testing.assert_array_equal(got, want)
    pts, rads = tplotter._cross_section_points(-20, 30, 20, 60, 2500, 0.0,
                                               5, 9)
    assert pts.shape == (45, 3) and rads.shape == (5,)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=1),
                               np.repeat(rads, 9), rtol=1e-14)


def test_plotter_imports_and_samples_without_matplotlib():
    """With matplotlib unimportable the package, the plotter and its
    sampling still work; only drawing needs it."""
    code = (
        "import sys; sys.modules['matplotlib'] = None\n"
        "from multimesh_tpu_torch import api, viz\n"
        "from multimesh_tpu_torch.viz import plotter\n"
        "p = plotter._create_depthslice(1e5, 4, (0, 10), (0, 10))\n"
        "x = plotter._cross_section_points(0, 0, 10, 10, 100, 0, 3, 5)\n"
        "assert p.shape == (16, 3) and x[0].shape == (15, 3)\n"
        "try:\n"
        "    viz.roma\n"
        "except ImportError:\n"
        "    print('drawing needs matplotlib')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "drawing needs matplotlib" in out.stdout


def _mesh_array(fig):
    return np.asarray(fig.axes[0].collections[0].get_array(), np.float64)


def test_depth_slice_figure_matches_jax(global_mesh, tmp_path):
    kw = dict(depth_in_km=500.0, num=12, parameter_to_plot="VSV",
              savefig=True)
    fig_t = tapi.plot_depth_slice(mesh=global_mesh, device="cpu",
                                  figname=str(tmp_path / "t.png"), **kw)
    fig_j = japi.plot_depth_slice(mesh=global_mesh,
                                  figname=str(tmp_path / "j.png"), **kw)
    got, want = _mesh_array(fig_t), _mesh_array(fig_j)
    assert got.shape == want.shape and got.size == 144
    assert (want != 0).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (tmp_path / "t.png").stat().st_size > 1000


def test_depth_slice_values_match_jax_points(global_mesh):
    """The slice's sampling helper against the JAX package's
    ``interpolate_to_points`` on the same lat/lon/depth grid."""
    got = tplotter._depth_slice_values(global_mesh, 800.0, 9, (-60, 70),
                                       (-170, 150), "VSH", device="cpu")
    pts = jplotter._create_depthslice(800e3, 9, (-60, 70), (-170, 150))
    want = np.asarray(japi.interpolate_to_points(
        mesh=global_mesh, points=pts, params_to_interp=["VSH"],
        make_spherical=False, geocentric=True)).reshape(9, 9)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_cross_section_figure_matches_jax(global_mesh, tmp_path):
    kw = dict(point_1_lat=-20, point_1_lng=30, point_2_lat=20,
              point_2_lng=60, max_depth_in_km=2500, nrads=20, npoints=30,
              param_to_interp="VSV")
    fig_t = tapi.plot_cross_section(mesh=global_mesh, device="cpu",
                                    filename=str(tmp_path / "t.png"), **kw)
    fig_j = japi.plot_cross_section(mesh=global_mesh,
                                    filename=str(tmp_path / "j.png"), **kw)
    got, want = _mesh_array(fig_t), _mesh_array(fig_j)
    assert got.shape == want.shape and got.size == 600
    # percent deviations 100 (v / mean - 1): values within 1e-6 relative
    # move them by up to 2e-4 percentage points
    assert np.abs(want).max() > 1
    assert np.abs(got - want).max() <= 2e-4
    assert (tmp_path / "t.png").stat().st_size > 1000
    # the values under the deviations, element by element
    pts, _ = tplotter._cross_section_points(-20, 30, 20, 60, 2500, 0.0, 20,
                                            30)
    vals = tplotter._cross_section_values(global_mesh, pts, 20, 30, "VSV",
                                          device="cpu")
    jvals = np.asarray(japi.interpolate_to_points(
        global_mesh, points=pts, make_spherical=True,
        params_to_interp=["VSV"])).reshape(20, 30)
    assert (jvals != 0).all()
    np.testing.assert_allclose(vals, jvals, rtol=1e-6, atol=0)
