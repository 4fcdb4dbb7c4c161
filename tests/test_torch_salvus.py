"""``multimesh_tpu_torch.io.salvus``, ``testing.write_salvus_fixture`` and
``ops.fluid`` against the JAX package's: a file written by either package
reads identically through the other's reader, write-back and dataset
re-creation behave the same (error cases included), and the fluid/solid
repair agrees bit for bit.
"""
import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.io import salvus as jsio  # noqa: E402
from multimesh_tpu.ops.fluid import (  # noqa: E402
    repair_fluid_solid as j_repair,
)
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch.io import salvus as tsio  # noqa: E402
from multimesh_tpu_torch.ops.fluid import (  # noqa: E402
    repair_fluid_solid as t_repair,
)

PACKAGES = {"jax": (jmt, jsio), "torch": (tmt, tsio)}


def _mesh(pkg):
    return pkg.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=2, n_layers=2)


def _assert_same_mesh(a, b):
    """Two SalvusMesh objects (of either package) hold the same file."""
    np.testing.assert_array_equal(a.points, b.points)
    assert (a.nelem, a.n_gll_points, a.dimensions, a.shape_order) == (
        b.nelem, b.n_gll_points, b.dimensions, b.shape_order)
    assert a.nodal_parameter_indices == b.nodal_parameter_indices
    assert a.elemental_parameter_indices == b.elemental_parameter_indices
    assert a.global_strings == b.global_strings
    for name in a.nodal_parameter_indices:
        np.testing.assert_array_equal(a.element_nodal_fields[name],
                                      b.element_nodal_fields[name])
    for name in a.elemental_parameter_indices:
        np.testing.assert_array_equal(a.elemental_fields[name],
                                      b.elemental_fields[name])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_fixture_reads_identically_through_both_readers(writer, tmp_path):
    """A fixture file of either package through both readers: points,
    data, labels (``z_node_1D`` is the fourth nodal parameter), elemental
    fields and global strings; the fields are the ones the writer
    returned, whichever package's fixture code made them."""
    wmt, _ = PACKAGES[writer]
    mesh = _mesh(wmt)
    fluid = np.zeros(mesh.nelem)
    fluid[::4] = 1.0
    path = tmp_path / "mesh.h5"
    nodal = wmt.write_salvus_fixture(
        path, mesh, parameters=("VP", "VS", "RHO"), fluid=fluid,
        global_strings={"moho_idx": "1"}, field_kind="linear")
    j, t = jsio.SalvusMesh(path, fast_mode=False), tsio.SalvusMesh(
        path, fast_mode=False)
    _assert_same_mesh(j, t)
    assert t.nodal_parameter_indices == ["VP", "VS", "RHO", "z_node_1D"]
    assert t.elemental_parameter_indices == ["fluid", "layer"]
    assert t.global_strings["moho_idx"] == b"1"
    np.testing.assert_array_equal(t.points, mesh.points)
    np.testing.assert_array_equal(t.elemental_fields["fluid"], fluid)
    for name, field in nodal.items():
        np.testing.assert_array_equal(t.element_nodal_fields[name], field)
    # lazy accessors of a fast-mode mesh, and the single-field readers
    lazy = tsio.SalvusMesh(path)
    assert lazy.element_nodal_fields == {}
    np.testing.assert_array_equal(lazy.get_element_nodal_fields()["VS"],
                                  nodal["VS"])
    np.testing.assert_array_equal(lazy.get_element_nodal_field("RHO"),
                                  nodal["RHO"])
    np.testing.assert_array_equal(lazy.get_elemental_field("layer"),
                                  mesh.layer_id)
    np.testing.assert_array_equal(lazy.get_element_centroids(),
                                  mesh.points.mean(axis=1))
    for sio in (jsio, tsio):
        pts, data, params = sio.load_hdf5_params(path)
        assert params == ["VP", "VS", "RHO", "z_node_1D"]
        np.testing.assert_array_equal(pts, mesh.points)
        np.testing.assert_array_equal(
            data, np.stack(list(nodal.values()), axis=1))


def test_both_fixture_writers_write_the_same_file(tmp_path):
    """The two packages' fixture code gives equal meshes and equal
    datasets, labels and attributes."""
    for name, (mt, _) in PACKAGES.items():
        mt.write_salvus_fixture(tmp_path / f"{name}.h5", _mesh(mt),
                                global_strings={"a": "b"})
    with h5py.File(tmp_path / "jax.h5") as fj, \
            h5py.File(tmp_path / "torch.h5") as ft:
        for path in ("MODEL/coordinates", "MODEL/data",
                     "MODEL/element_data"):
            np.testing.assert_array_equal(fj[path][()], ft[path][()])
            assert [d.label for d in fj[path].dims] == [
                d.label for d in ft[path].dims]
        assert dict(fj["MODEL"].attrs) == dict(ft["MODEL"].attrs)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_write_salvus_mesh_and_the_grad_strip(writer, reader, tmp_path):
    """``write_salvus_mesh`` of one package, ``load_hdf5_params`` and
    ``SalvusMesh`` of the other: ``grad`` is stripped from the labels by
    ``load_hdf5_params`` only, and a file without element data reads."""
    wmt, wsio = PACKAGES[writer]
    _, rsio = PACKAGES[reader]
    mesh = wmt.box_mesh(shape=(2, 2, 2), order=1)
    field = wmt.element_nodal_field(mesh)
    path = tmp_path / "m.h5"
    wsio.write_salvus_mesh(path, mesh.points,
                           {"gradVP": field, "VS": 2.0 * field})
    pts, data, params = rsio.load_hdf5_params(path)
    assert params == ["VP", "VS"]
    assert data.shape == (mesh.nelem, 2, 8)
    np.testing.assert_array_equal(data[:, 1], 2.0 * field)
    sm = rsio.SalvusMesh(path)
    assert sm.nodal_parameter_indices == ["gradVP", "VS"]
    assert sm.elemental_parameter_indices == []
    assert sm.get_elemental_fields() == {}


def test_labels_and_missing_labels():
    params = ["VPV", "VPH", "RHO", "QKAPPA"]
    assert tsio.format_dim_label(params) == jsio.format_dim_label(params)
    label = tsio.format_dim_label(params)
    assert tsio.parse_dim_label(label) == params
    assert tsio.parse_dim_label(label.encode()) == params


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_attach_field_and_recreate_dataset(pkg, tmp_path):
    """Write-back of nodal and elemental fields, the error cases, a
    global string update and ``recreate_dataset``: the same in both
    packages, each file read back through the OTHER package."""
    mt, sio = PACKAGES[pkg]
    _, other = PACKAGES["torch" if pkg == "jax" else "jax"]
    mesh = _mesh(mt)
    path = tmp_path / "mesh.h5"
    nodal = mt.write_salvus_fixture(path, mesh, parameters=("VP", "VS"))
    sm = sio.SalvusMesh(path, fast_mode=False)
    sm.attach_field("VS", nodal["VS"] * 2.0)
    sm.attach_field("layer", np.arange(mesh.nelem, dtype=np.float64))
    back = other.SalvusMesh(path, fast_mode=False)
    np.testing.assert_array_equal(back.element_nodal_fields["VS"],
                                  nodal["VS"] * 2.0)
    np.testing.assert_array_equal(back.element_nodal_fields["VP"],
                                  nodal["VP"])
    np.testing.assert_array_equal(back.elemental_fields["layer"],
                                  np.arange(mesh.nelem))
    with pytest.raises(ValueError, match="not present"):
        sm.attach_field("NOPE", nodal["VS"])
    with pytest.raises(ValueError, match="not present"):
        sm.attach_field("NOPE", np.zeros(mesh.nelem))
    with pytest.raises(ValueError, match="matches neither"):
        sm.attach_field("VS", nodal["VS"][:, :2])
    sm.set_global_string("moho_idx", "2")
    assert other.SalvusMesh(path).global_strings["moho_idx"] == b"2"

    with h5py.File(path, "r+") as f:
        sio.recreate_dataset(f, ["A", "B", "C", "D", "E"])
        assert f["MODEL/data"].shape == (mesh.nelem, 5, 27)
        assert f["MODEL/data"].dtype == np.float64
        assert other.read_dim_labels(f["MODEL/data"]) == list("ABCDE")
        assert not f["MODEL/data"][()].any()
        del f["MODEL/data"].attrs["DIMENSION_LABELS"]
        with pytest.raises(KeyError, match="DIMENSION_LABELS"):
            sio.read_dim_labels(f["MODEL/data"])
    with pytest.raises(KeyError, match="DIMENSION_LABELS"):
        sio.load_hdf5_params(path)


def _repair_case(kind):
    """Seeded [nelem, 3, n_gll] values: fluid elements, solid elements
    that received a zero shear velocity, and clean ones."""
    rng = np.random.default_rng(11)
    nelem, n = 12, 27
    new = rng.uniform(1.0, 5.0, (nelem, 3, n))
    old = rng.uniform(6.0, 9.0, (nelem, 3, n))
    solid = np.ones(nelem, bool)
    params = ["VP", "VS", "RHO"]
    if kind in ("fluid_and_zero_vs", "vsv"):
        solid[[0, 5, 6]] = False
        new[3, 1, 4] = 0.0   # solid, zero VS: reverts whole
        new[5, 1, 0] = 0.0   # fluid, zero VS: keeps old anyway
        new[8, 0, 2] = 0.0   # zero VP is no reason to revert
    if kind == "vsv":
        params = ["VPV", "VSV", "RHO"]
    if kind == "no_shear_parameter":
        solid[[1, 2]] = False
        new[4, 1, 4] = 0.0
        params = ["VP", "QMU", "RHO"]
    return new, old, solid, params


@pytest.mark.parametrize("kind", ["fluid_and_zero_vs", "vsv",
                                  "no_shear_parameter", "all_solid_clean"])
def test_repair_fluid_solid_equals_jax(kind):
    new, old, solid, params = _repair_case(kind)
    kept = new.copy()
    got = t_repair(new, old, solid, params)
    np.testing.assert_array_equal(got, j_repair(new, old, solid, params))
    np.testing.assert_array_equal(new, kept)  # the input is not written
    np.testing.assert_array_equal(got[~solid], old[~solid])
    if kind in ("fluid_and_zero_vs", "vsv"):
        np.testing.assert_array_equal(got[3], old[3])
        np.testing.assert_array_equal(got[8], new[8])
    if kind == "no_shear_parameter":
        np.testing.assert_array_equal(got[4], new[4])
    if kind == "all_solid_clean":
        np.testing.assert_array_equal(got, new)
