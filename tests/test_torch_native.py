"""``multimesh_tpu_torch.native``: ctypes bindings over the repo's
``native/src/mmt_native.cpp``, built at first use into the package's
``_build/`` (never the committed ``native/libmmt_native.so``), held
against the port's torch core and against the JAX package's bindings on
the same inputs, atol 1e-13.  Both bindings drive the same C++ source,
built with other flags, so their results differ by at most a few ulp.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import native as jnative  # noqa: E402
from multimesh_tpu_torch import native as tnative  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch.config import LocateConfig, Precision  # noqa: E402
from multimesh_tpu_torch.core import gll as tgll  # noqa: E402
from multimesh_tpu_torch.core import shape as tshape  # noqa: E402
from multimesh_tpu_torch.native import bindings  # noqa: E402
from multimesh_tpu_torch.search import knn as tknn  # noqa: E402
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402

ATOL = 1e-13


@pytest.fixture(scope="module")
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library is not built")
    return jnative


def test_library_is_built_from_the_source_into_the_package():
    path = bindings.build()
    assert path == bindings.library_path() and path.exists()
    assert path.parent == bindings.BUILD_DIR
    assert path.parent.parent.name == "multimesh_tpu_torch"
    assert bindings.SOURCE.name == "mmt_native.cpp"
    assert "-march=native" not in bindings.CXX_FLAGS
    assert tnative.available()
    assert os.path.samefile(tnative.load()._name, path)


def test_builds_without_openmp_where_the_compiler_has_none(monkeypatch):
    """A toolchain that cannot link ``-fopenmp`` (no libgomp) builds the
    library without it, under another name; its serial loops give the
    same results as the OpenMP build's."""
    ref = np.random.default_rng(9).uniform(-1, 1, (200, 3))
    want = tnative.gll_basis(4, ref)
    assert bindings.OPENMP_FLAG in bindings.flags()
    omp_path = bindings.library_path()
    monkeypatch.setattr(bindings, "_openmp", lambda cxx: False)
    monkeypatch.setattr(bindings, "_cache", [])
    assert bindings.OPENMP_FLAG not in bindings.flags()
    assert bindings.library_path() != omp_path
    np.testing.assert_array_equal(tnative.gll_basis(4, ref), want)
    assert os.path.samefile(tnative.load()._name, bindings.library_path())


def test_env_library_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setattr(bindings, "_cache", [])
    monkeypatch.setenv("MMT_NATIVE_LIB", str(bindings.build()))
    lib = tnative.load()
    assert os.path.samefile(lib._name, bindings.library_path())
    monkeypatch.setattr(bindings, "_cache", [])
    monkeypatch.setenv("MMT_NATIVE_LIB", str(tmp_path / "missing.so"))
    with pytest.raises(FileNotFoundError, match="MMT_NATIVE_LIB"):
        tnative.load()
    with pytest.raises(FileNotFoundError):
        tnative.available()


def test_centroids(jax_native):
    mesh = tmt.box_mesh(shape=(3, 4, 2), order=1, warp=0.1)
    got = tnative.centroids(mesh.connectivity, mesh.vertices)
    np.testing.assert_allclose(
        got, mesh.vertices[mesh.connectivity].mean(axis=1), rtol=0,
        atol=ATOL)
    np.testing.assert_allclose(
        got, jax_native.centroids(mesh.connectivity, mesh.vertices), rtol=0,
        atol=ATOL)


@pytest.mark.parametrize("order,dim", [(1, 3), (2, 2), (3, 3), (4, 3),
                                       (5, 2), (6, 3), (7, 3)])
def test_gll_basis(order, dim, jax_native):
    ref = np.random.default_rng(order * dim).uniform(-1.1, 1.1, (64, dim))
    got = tnative.gll_basis(order, ref)
    want = tgll.tensor_basis(order, torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, jax_native.gll_basis(order, ref),
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="order"):
        tnative.gll_basis(9, ref)


@pytest.mark.parametrize("order", [1, 2, 4, 6])
def test_inverse_map(order, jax_native):
    """Known refs in warped elements: the native Newton, the port's f64
    ``inverse_map`` and the JAX bindings give the same refs."""
    mesh = tmt.box_mesh(shape=(2, 2, 2), order=order, warp=0.1)
    rng = np.random.default_rng(order)
    ids = rng.integers(0, mesh.nelem, 50)
    nodes = np.ascontiguousarray(mesh.points[ids])
    refs_true = rng.uniform(-0.95, 0.95, (50, 3))
    pts = tshape.forward_map(order, torch.from_numpy(nodes),
                             torch.from_numpy(refs_true)).numpy()
    # a residual under 1e-14 of the element: refs converged to f64 grade,
    # not to the default stop's 1e-12
    got, conv = tnative.inverse_map(nodes, pts, order, rtol=1e-14)
    assert conv.all()
    np.testing.assert_allclose(got, refs_true, rtol=0, atol=1e-12)
    want, tconv = tshape.inverse_map(torch.from_numpy(nodes),
                                     torch.from_numpy(pts), order)
    assert tconv.all()
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=ATOL)
    j_refs, j_conv = jax_native.inverse_map(nodes, pts, order, rtol=1e-14)
    np.testing.assert_array_equal(conv, j_conv)
    np.testing.assert_allclose(got, j_refs, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="rows"):
        tnative.inverse_map(nodes[:-1], pts, order)


@pytest.mark.parametrize("fallback", ["sentinel", "snap", "best"])
def test_locate(fallback, jax_native):
    """The candidate scan (its Newton run to a residual under 1e-14 of
    the element) against the JAX bindings (every output), and against
    the port's ``locate`` on the same candidates with ``Precision.F64``
    where both accept: the same elements, refs and weights to 1e-13."""
    mesh = tmt.box_mesh(shape=(3, 3, 3), order=2, warp=0.1)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.05, 1.05, (300, 3))
    cand = tknn.knn(torch.as_tensor(mesh.centroids()),
                    torch.from_numpy(pts), 6)[1].numpy().astype(np.int64)
    got = tnative.locate(pts, cand, mesh.points, 2, fallback=fallback,
                         rtol=1e-14)
    want = jax_native.locate(pts, cand, mesh.points, 2, fallback=fallback,
                             rtol=1e-14)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[3] == want[3]
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    port = tloc.locate(pts, mesh.points, 2,
                       LocateConfig(precision=Precision.F64,
                                    nelem_to_search=6),
                       fallback="sentinel", candidates=cand,
                       strategy="scan", device="cpu")
    inside = ((pts > 0) & (pts < 1)).all(axis=1)
    both = inside & (got[0] == port.elements.numpy())
    assert both.mean() > 0.95 * inside.mean()
    np.testing.assert_allclose(got[1][both], port.refs.numpy()[both],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[2][both], port.weights.numpy()[both],
                               rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="candidate ids"):
        tnative.locate(pts, cand + 100, mesh.points, 2)
