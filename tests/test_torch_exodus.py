"""``multimesh_tpu_torch.io.exodus`` and ``testing.write_exodus_fixture``:
the JAX package's four Exodus I/O cases (round trip, 2-D, attach of a new
variable, refusal of unmodelled files) run against the port, and a file
written by each package read by the other: fields and connectivity equal
(host numpy and scipy on both sides, so equal means bit-equal).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.io import exodus as jeio  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch.core import gll as tgll  # noqa: E402
from multimesh_tpu_torch.io import exodus as teio  # noqa: E402


def test_permutations_equal_jax():
    np.testing.assert_array_equal(teio.HEX8_TO_CANONICAL,
                                  jeio.HEX8_TO_CANONICAL)
    np.testing.assert_array_equal(teio.QUAD4_TO_CANONICAL,
                                  jeio.QUAD4_TO_CANONICAL)
    assert sorted(teio.HEX8_TO_CANONICAL) == list(range(8))


def test_exodus_roundtrip(tmp_path):
    mesh = tmt.box_mesh(shape=(3, 2, 2), order=1)
    path = tmp_path / "mesh.e"
    nodal = tmt.write_exodus_fixture(path, mesh, parameters=("VP", "RHO"))

    e = teio.Exodus(path)
    assert e.nelem == mesh.nelem
    assert e.nodes_per_element == 8
    assert e.ndim == 3
    assert e.npoint == len(mesh.vertices)
    np.testing.assert_allclose(e.points, mesh.vertices)
    assert e.nodal_parameters == ["VP", "RHO"]
    assert e.elem_var_names == ["something_elemental"]
    np.testing.assert_allclose(e.get_nodal_field("RHO"), nodal["RHO"])
    np.testing.assert_allclose(
        e.get_element_field("something_elemental"),
        np.arange(mesh.nelem, dtype=float),
    )
    with pytest.raises(KeyError):
        e.get_nodal_field("NOPE")
    with pytest.raises(KeyError):
        e.get_element_field("NOPE")
    # canonical corner nodes must match the fixture's element corners
    ci = tgll.corner_indices(mesh.order, 3)
    np.testing.assert_allclose(
        e.canonical_corner_nodes(), mesh.points[:, ci, :]
    )
    np.testing.assert_allclose(
        e.get_element_centroid(), mesh.vertices[mesh.connectivity].mean(1)
    )

    # write-back
    with pytest.raises(PermissionError):
        e.attach_field("VP", nodal["VP"] * 2)
    with pytest.raises(ValueError):
        teio.Exodus(path, mode="w")
    ea = teio.Exodus(path, mode="a")
    ea.attach_field("VP", nodal["VP"] * 2)
    np.testing.assert_allclose(
        teio.Exodus(path).get_nodal_field("VP"), nodal["VP"] * 2
    )
    with pytest.raises(ValueError):
        ea.attach_field("VP", np.zeros(5))


def test_exodus_2d(tmp_path):
    mesh = tmt.box_mesh(shape=(3, 3), order=1)
    path = tmp_path / "mesh2d.e"
    tmt.write_exodus_fixture(path, mesh, parameters=("V",))
    e = teio.Exodus(path)
    assert e.ndim == 2
    assert e.nodes_per_element == 4
    np.testing.assert_allclose(e.points, mesh.vertices)
    ci = tgll.corner_indices(mesh.order, 2)
    np.testing.assert_allclose(
        e.canonical_corner_nodes(), mesh.points[:, ci, :]
    )


def test_exodus_attach_new_variable(tmp_path):
    """Attaching an undeclared variable declares it on the fly."""
    mesh = tmt.box_mesh(shape=(3, 3, 3), order=1)
    path = tmp_path / "mesh.e"
    tmt.write_exodus_fixture(path, mesh, parameters=("VP",))
    ea = teio.Exodus(path, mode="a")
    old_vp = ea.get_nodal_field("VP")

    grad = np.linspace(0.0, 1.0, ea.npoint)
    ea.attach_field("GRAD_VS", grad)  # new nodal variable
    fluid = np.arange(ea.nelem, dtype=np.float64)
    ea.attach_field("fluid", fluid)  # new elemental variable

    for reader in (teio.Exodus, jeio.Exodus):
        e2 = reader(path)
        assert "GRAD_VS" in e2.nodal_parameters
        assert "fluid" in e2.elem_var_names
        np.testing.assert_allclose(e2.get_nodal_field("GRAD_VS"), grad)
        np.testing.assert_allclose(e2.get_element_field("fluid"), fluid)
        # pre-existing data survives the header rewrite
        np.testing.assert_allclose(e2.get_nodal_field("VP"), old_vp)
        np.testing.assert_allclose(e2.points, mesh.vertices)
        np.testing.assert_allclose(e2.connectivity, ea.connectivity)


def test_exodus_declare_refuses_unmodeled_files(tmp_path):
    """A file holding structures the minimal writer does not model (side
    sets etc.) must refuse attach-field auto-declare instead of silently
    rewriting them away."""
    from scipy.io import netcdf_file

    mesh = tmt.box_mesh(shape=(3, 3, 3), order=1)
    path = tmp_path / "mesh.e"
    tmt.write_exodus_fixture(path, mesh, parameters=("VP",))
    with netcdf_file(str(path), "a", mmap=False) as f:
        f.createDimension("num_side_sets", 1)
        v = f.createVariable("elem_ss1", "i", ("num_side_sets",))
        v[:] = np.array([1], np.int32)
    ea = teio.Exodus(path, mode="a")
    # in-place write of an EXISTING variable still works
    ea.attach_field("VP", ea.get_nodal_field("VP") * 2)
    with pytest.raises(KeyError, match="does not model"):
        ea.attach_field("NEW_VAR", np.zeros(ea.npoint))


def _same(a, b):
    assert (a.ndim, a.nelem, a.nodes_per_element, a.npoint) == (
        b.ndim, b.nelem, b.nodes_per_element, b.npoint)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_array_equal(a.connectivity, b.connectivity)
    np.testing.assert_array_equal(a.canonical_connectivity(),
                                  b.canonical_connectivity())
    np.testing.assert_array_equal(a.canonical_corner_nodes(),
                                  b.canonical_corner_nodes())
    assert a.nodal_parameters == b.nodal_parameters
    assert a.elem_var_names == b.elem_var_names
    for p in a.nodal_parameters:
        np.testing.assert_array_equal(a.get_nodal_field(p),
                                      b.get_nodal_field(p))
    for p in a.elem_var_names:
        np.testing.assert_array_equal(a.get_element_field(p),
                                      b.get_element_field(p))


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("shape", [(3, 2, 2), (4, 3)])
def test_file_of_one_package_read_by_the_other(tmp_path, writer, shape):
    """Fields and connectivity equal whichever package wrote the file and
    whichever reads it, also after an attach (in place, and of a new
    variable: the header rewrite) by the other package."""
    mesh = tmt.box_mesh(shape=shape, order=1)
    path = tmp_path / "m.e"
    if writer == "torch":
        tmt.write_exodus_fixture(path, mesh, parameters=("VP", "VS"))
        other = jeio
    else:
        jmt.write_exodus_fixture(path, jmt.box_mesh(shape=shape, order=1),
                                 parameters=("VP", "VS"))
        other = teio
    _same(teio.Exodus(path), jeio.Exodus(path))
    ea = other.Exodus(path, mode="a")
    rng = np.random.default_rng(3)
    vs = rng.normal(size=ea.npoint)
    new = rng.normal(size=ea.npoint)
    ea.attach_field("VS", vs)
    ea.attach_field("NEW", new)
    t, j = teio.Exodus(path), jeio.Exodus(path)
    _same(t, j)
    np.testing.assert_array_equal(t.get_nodal_field("VS"), vs)
    np.testing.assert_array_equal(t.get_nodal_field("NEW"), new)
    np.testing.assert_array_equal(t.points, mesh.vertices)
