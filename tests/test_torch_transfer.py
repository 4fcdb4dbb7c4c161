"""The slice as a whole: ``TransferOperator.build(...).apply(...)`` of the
port against the JAX package's ``TransferOperator`` (also with the df32
polish and its pair apply), the exchange of operator state between the
two packages (``from_numpy``, ``save`` and ``load`` in one on-disk
format, ``refs_lo.npy`` included), and the port's independence from JAX.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.config import LocateConfig, Precision  # noqa: E402
from multimesh_tpu.hashing import content_fingerprint  # noqa: E402
from multimesh_tpu.ops import TransferOperator as JOp  # noqa: E402
from multimesh_tpu_torch import TransferOperator as TOp  # noqa: E402
from multimesh_tpu_torch import config as tconfig  # noqa: E402
from multimesh_tpu_torch.core import gll as tgll  # noqa: E402
from multimesh_tpu_torch.hashing import (  # noqa: E402
    content_fingerprint as t_fingerprint,
)
from multimesh_tpu_torch.search import grid as tgrid  # noqa: E402
from multimesh_tpu_torch.search import locate as tlocate  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048
ORDER = 4


@pytest.fixture(scope="module")
def slice_case():
    """The slice's configuration cut to a few elements: the order-4
    shell (E = 80), targets drawn as bench.py draws them (all inside the
    shell), 3 parameters, snap fallback, MIXED precision."""
    mesh = jmt.shell_mesh(n_lat=4, n_lon=5, n_rad=4, order=ORDER)
    rng = np.random.default_rng(5)
    r = rng.uniform(3.6e6, 6.3e6, N)
    th = rng.uniform(0.55, 1.15, N)
    ph = rng.uniform(0.35, 1.35, N)
    pts = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                    r * np.cos(th)], -1)
    base = jmt.element_nodal_field(mesh, "smooth")
    fields = np.stack([base * (1 + 0.1 * i) for i in range(3)])
    return mesh, pts, fields


@pytest.fixture(scope="module")
def jax_op(slice_case):
    mesh, pts, _ = slice_case
    cfg = LocateConfig(nelem_to_search=20, precision=Precision.MIXED)
    return JOp.build(mesh.points, pts, order=ORDER, cfg=cfg,
                     fallback="snap")


@pytest.fixture(scope="module")
def torch_op(slice_case):
    mesh, pts, _ = slice_case
    cfg = tconfig.LocateConfig(nelem_to_search=20,
                               precision=tconfig.Precision.MIXED)
    return TOp.build(mesh.points, pts, order=ORDER, cfg=cfg,
                     fallback="snap", device="cpu")


def test_build_apply_matches_jax(slice_case, jax_op, torch_op):
    """Every target is inside the shell, so both operators accept every
    row; elements agree on >= 95% (a point on a shared face belongs to
    either element), and the applied values agree to rtol 1e-5 on every
    row -- f32 refs move an interpolated value by ~1e-7 relative, and on
    a shared face both elements interpolate the same continuous field."""
    mesh, pts, fields = slice_case
    want = np.asarray(jax_op.apply(fields))
    got = torch_op.apply(torch.from_numpy(fields))
    assert got.shape == (N, 3) and got.dtype == torch.float32
    assert torch_op.found.all() and torch_op.num_missing == 0
    assert (torch_op.elements.numpy() == np.asarray(jax_op.elements)).mean() \
        >= 0.95
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_accuracy_against_the_analytic_field(slice_case, jax_op, torch_op):
    """The interpolation error against the analytic field is the mesh's,
    not the port's: at most the JAX operator's error plus 1e-6."""
    mesh, pts, fields = slice_case
    truth = jmt.smooth_field(pts)
    got = torch_op.apply(torch.from_numpy(fields[0])).numpy()
    want = np.asarray(jax_op.apply(fields[0]))
    err_t = np.max(np.abs(got - truth) / np.abs(truth))
    err_j = np.max(np.abs(want - truth) / np.abs(truth))
    assert err_t <= err_j + 1e-6, (err_t, err_j)


def test_single_field_and_chunked_apply(slice_case, torch_op):
    """One field [E, n] gives [N]; apply chunks agree with one chunk."""
    _, _, fields = slice_case
    stack = torch_op.apply(torch.from_numpy(fields))
    one = torch_op.apply(torch.from_numpy(fields[1]))
    chunked = torch_op.apply(torch.from_numpy(fields), chunk=300)
    assert one.shape == (N,)
    assert torch.equal(one, stack[:, 1])
    np.testing.assert_allclose(chunked.numpy(), stack.numpy(), rtol=1e-6)


def test_weights_match_jax(jax_op, torch_op):
    """Weights materialised from the refs: where the elements agree the
    basis at f32 refs matches the JAX weights to 1e-5 (absolute, on
    weights of magnitude <= ~1)."""
    same = torch_op.elements.numpy() == np.asarray(jax_op.elements)
    np.testing.assert_allclose(torch_op.weights.numpy()[same],
                               np.asarray(jax_op.weights)[same], atol=1e-5)


def test_from_numpy_carries_jax_state(slice_case, jax_op):
    """The JAX operator's state as numpy arrays applies in the port like
    it does in JAX: the refs keep their f64 dtype, so rtol 1e-6 (sums in
    another order)."""
    _, _, fields = slice_case
    op = TOp.from_numpy(np.asarray(jax_op.elements), np.asarray(jax_op.refs),
                        np.asarray(jax_op.found), ORDER, device="cpu")
    assert op.refs.dtype == torch.float64
    np.testing.assert_allclose(op.apply(torch.from_numpy(fields)).numpy(),
                               np.asarray(jax_op.apply(fields)), rtol=1e-6)


def test_jax_saved_operator_loads_in_port(slice_case, jax_op, tmp_path):
    """JAX save -> port load (with the fingerprint check) -> apply."""
    mesh, pts, fields = slice_case
    fp = content_fingerprint(mesh.points, pts)
    recon = np.random.default_rng(0).integers(0, N, 3000)
    jax_op.recon = recon
    try:
        jax_op.save(tmp_path, fingerprint=fp)
        want = np.asarray(jax_op.apply(fields))
    finally:
        jax_op.recon = None
    assert TOp.exists(tmp_path)
    op = TOp.load(tmp_path, fingerprint=fp, device="cpu")
    got = op.apply(torch.from_numpy(fields)).numpy()
    assert got.shape == (3000, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_port_saved_operator_loads_in_jax(slice_case, torch_op, tmp_path):
    """Port save -> JAX load -> apply, compact and dense formats."""
    mesh, pts, fields = slice_case
    fp = t_fingerprint(mesh.points, pts)
    want = torch_op.apply(torch.from_numpy(fields)).numpy()
    for dense in (False, True):
        d = tmp_path / ("dense" if dense else "compact")
        torch_op.save(d, fingerprint=fp, dense=dense)
        assert os.path.exists(d / ("coeffs.npy" if dense else "refs.npy"))
        op = JOp.load(d, fingerprint=fp)
        np.testing.assert_allclose(np.asarray(op.apply(fields)), want,
                                   rtol=1e-6)
        back = TOp.load(d, fingerprint=fp, device="cpu")
        np.testing.assert_allclose(
            back.apply(torch.from_numpy(fields)).numpy(), want, rtol=1e-6)


def test_fingerprints_agree_and_load_refuses_another(slice_case, torch_op,
                                                     tmp_path):
    """Both packages hash alike, and a cache saved for other geometry
    (or without a fingerprint) is refused, never applied."""
    mesh, pts, _ = slice_case
    fp = t_fingerprint(mesh.points, pts)
    assert fp == content_fingerprint(mesh.points, pts)
    torch_op.save(tmp_path / "a", fingerprint=fp)
    with pytest.raises(ValueError, match="different geometry"):
        TOp.load(tmp_path / "a", fingerprint=fp ^ 1, device="cpu")
    torch_op.save(tmp_path / "b")
    with pytest.raises(ValueError, match="different geometry"):
        TOp.load(tmp_path / "b", fingerprint=fp, device="cpu")
    assert not TOp.exists(tmp_path / "missing")


def test_missing_elements_give_zero(slice_case):
    """Element -1 (sentinel, not found) applies to 0, as in JAX."""
    mesh, pts, fields = slice_case
    op = TOp.build(mesh.points, pts[:64] * 3.0, order=ORDER, device="cpu")
    assert op.num_missing == 64
    assert (op.apply(torch.from_numpy(fields)) == 0).all()


def test_port_imports_no_jax():
    """Importing every module of the port loads neither JAX nor the JAX
    package (a fresh interpreter, so this test's own imports do not
    count), and the package root alone loads no ``h5py`` either: only
    the file entry points need it."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multimesh_tpu_torch as p\n"
        "import multimesh_tpu_torch.api, multimesh_tpu_torch.engine\n"
        "assert 'h5py' not in sys.modules, 'h5py loaded by the root'\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'\n"
        "             or k.startswith(('jax.', 'jaxlib'))\n"
        "             or k == 'multimesh_tpu'\n"
        "             or k.startswith('multimesh_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules\n"
        "                 if k.startswith('multimesh_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    assert int(out.stdout.split()[1]) >= 24
    assert 'multimesh_tpu_torch.search.grid' in sys.modules


@pytest.fixture(scope="module")
def df32_op(slice_case):
    """The slice's operator with ``df32_polish=True`` (K4's twin on the
    CPU)."""
    mesh, pts, _ = slice_case
    cfg = tconfig.LocateConfig(nelem_to_search=20,
                               precision=tconfig.Precision.MIXED,
                               df32_polish=True)
    return TOp.build(mesh.points, pts, order=ORDER, cfg=cfg,
                     fallback="snap", device="cpu")


def test_df32_operator_matches_jax_f64(slice_case, jax_op, torch_op,
                                       df32_op):
    """The df32 operator's pair apply (K5's twin) gives f64 values: on
    rows whose elements agree (>= 95%; a shared face belongs to either)
    they match the JAX xla operator's f64 refs to rtol 1e-10, and its
    error against the analytic field is no larger than the JAX
    operator's plus 1e-10."""
    mesh, pts, fields = slice_case
    assert df32_op.refs_lo is not None and df32_op.refs.dtype == torch.float32
    assert torch.equal(df32_op.elements, torch_op.elements)
    got = df32_op.apply(torch.from_numpy(fields))
    assert got.dtype == torch.float64 and got.shape == (N, 3)
    want = np.asarray(jax_op.apply(fields))
    same = df32_op.elements.numpy() == np.asarray(jax_op.elements)
    assert same.mean() >= 0.95
    np.testing.assert_allclose(got.numpy()[same], want[same], rtol=1e-10)
    truth = jmt.smooth_field(pts)
    err_t = np.max(np.abs(got.numpy()[:, 0] - truth) / np.abs(truth))
    err_j = np.max(np.abs(want[:, 0] - truth) / np.abs(truth))
    assert err_t <= err_j + 1e-10, (err_t, err_j)


def test_df32_weights_and_save_load_roundtrip(slice_case, df32_op,
                                              tmp_path):
    """``weights`` come from the f64 sum of the pair; save writes
    refs_lo.npy, load reads it back, and the dense save keeps the pair's
    precision."""
    _, _, fields = slice_case
    pair = df32_op.refs.double() + df32_op.refs_lo.double()
    w = df32_op.weights
    assert w.dtype == torch.float64
    assert torch.equal(w, tgll.tensor_basis(ORDER, pair))
    want = df32_op.apply(torch.from_numpy(fields))
    df32_op.save(tmp_path / "compact")
    assert os.path.exists(tmp_path / "compact" / "refs_lo.npy")
    back = TOp.load(tmp_path / "compact", device="cpu")
    assert torch.equal(back.refs_lo, df32_op.refs_lo)
    assert torch.equal(back.apply(torch.from_numpy(fields)), want)
    df32_op.save(tmp_path / "dense", dense=True)
    dense = TOp.load(tmp_path / "dense", device="cpu")
    np.testing.assert_allclose(dense.apply(torch.from_numpy(fields)).numpy(),
                               want.numpy(), rtol=1e-13)


@pytest.fixture(scope="module")
def pair_state():
    """Seeded df32 operator state on an order-2 shell (the JAX pair apply
    is exact under ``disable_jit`` at order 2; at order 4 its interpret
    kernel is not): elements with some -1, f32 refs, f32 residuals."""
    order, M = 2, 300
    mesh = jmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=order)
    rng = np.random.default_rng(9)
    refs = rng.uniform(-0.99, 0.99, (M, 3))
    hi = refs.astype(np.float32)
    lo = (refs - hi.astype(np.float64)).astype(np.float32)
    elements = rng.integers(0, mesh.nelem, M).astype(np.int32)
    elements[::17] = -1
    base = jmt.element_nodal_field(mesh, "smooth")
    fields = np.stack([base, 2.0 * base + 1.0, base ** 2])
    return order, elements, hi, lo, elements >= 0, fields


def test_jax_df32_operator_loads_in_port(pair_state, tmp_path):
    """A JAX operator built from seeded (elements, refs, refs_lo, found)
    and written by its ``save`` loads in the port, and applies to within
    1e-11 relative of the JAX pair apply (``_apply_df32`` under
    ``disable_jit``)."""
    order, elements, hi, lo, found, fields = pair_state
    jop = JOp(elements=elements, order=order, refs=hi, found=found,
              refs_lo=lo)
    jop.save(tmp_path)
    with jax.disable_jit():
        want = np.asarray(jop._apply_df32(jnp.asarray(fields),
                                          jnp.asarray(elements), 1 << 20)[0])
    op = TOp.load(tmp_path, device="cpu")
    assert op.refs_lo is not None
    got = op.apply(torch.from_numpy(fields)).numpy()
    assert (got[elements < 0] == 0).all()
    scale = np.maximum(np.abs(want), 1e-12)
    assert np.max(np.abs(got - want) / scale) < 1e-11


def test_port_df32_operator_loads_in_jax(pair_state, tmp_path):
    """An operator made by the port's ``from_numpy(..., refs_lo=...)`` and
    written by its ``save`` loads in the JAX package with the same pair,
    whose f64 weights equal the port's."""
    order, elements, hi, lo, found, fields = pair_state
    op = TOp.from_numpy(elements, hi, found, order, refs_lo=lo,
                        device="cpu")
    op.save(tmp_path)
    jop = JOp.load(tmp_path)
    np.testing.assert_array_equal(np.asarray(jop.refs_lo), lo)
    np.testing.assert_array_equal(np.asarray(jop.refs), hi)
    np.testing.assert_allclose(np.asarray(jop.weights), op.weights.numpy(),
                               rtol=0, atol=1e-15)


def test_scan_locate_result_applies_as_the_ladder(slice_case, torch_op):
    """An operator made from ``locate(strategy="scan", prefilter_m=4)``
    (as the scan's callers make it) accepts every interior row, with
    elements as the ladder-built operator's on >= 99.9% of rows (both
    accept first in distance order) and values to rtol 1e-5 on all."""
    mesh, pts, fields = slice_case
    res = tlocate.locate(pts[:512], mesh.points, ORDER, fallback="snap",
                         prefilter_m=4, strategy="scan", want_weights=False,
                         device="cpu")
    assert res.n_retry == 0 and res.accepted.all()
    op = TOp(res.elements, ORDER, res.refs, res.found)
    agree = (op.elements == torch_op.elements[:512]).double().mean()
    assert float(agree) >= 0.999
    f = torch.from_numpy(fields)
    np.testing.assert_allclose(op.apply(f).numpy(),
                               torch_op.apply(f)[:512].numpy(), rtol=1e-5)


def test_grid_route_operator_matches_jax(monkeypatch):
    """build + apply over the grid route (the threshold lowered to 64 in
    both packages, 32-member round-1 bins, so a 1,024-element order-2
    shell takes it) against the JAX operator of the JAX ladder on the same
    route: the applied values differ by at most 1e-5 of the field's range
    on every row (all targets inside the shell; on a shared face either
    element interpolates the same continuous field), and the JAX
    operator's arrays, taken over with ``from_numpy``, apply identically
    in both packages to f32 rounding."""
    import importlib

    from multimesh_tpu.search import locate as jlocate

    jgrid = importlib.import_module("multimesh_tpu.search.grid")
    monkeypatch.setattr(jgrid, "APPROX_GRID_MIN_SOURCES", 64)
    monkeypatch.setenv("MMT_R1_M", "32")
    monkeypatch.setattr(tgrid, "APPROX_GRID_MIN_SOURCES", 64)
    monkeypatch.setattr(tlocate, "ROUND1_MEMBERS", 32)
    mesh = jmt.shell_mesh(n_lat=16, n_lon=16, n_rad=4, order=2)
    rng = np.random.default_rng(8)
    r = rng.uniform(3.6e6, 6.3e6, N)
    th = rng.uniform(0.55, 1.15, N)
    ph = rng.uniform(0.35, 1.35, N)
    pts = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                    r * np.cos(th)], -1)
    base = jmt.element_nodal_field(mesh, "smooth")
    fields = np.stack([base * (1 + 0.1 * i) for i in range(3)])
    span = fields.max() - fields.min()

    res = jlocate(pts, mesh.points, 2,
                  LocateConfig(nelem_to_search=20, precision=Precision.MIXED),
                  fallback="snap", engine="xla", strategy="ladder",
                  want_weights=False)
    j_op = JOp(elements=res.elements, order=2, refs=res.refs,
               found=res.found)
    want = np.asarray(j_op.apply(jnp.asarray(fields)))

    tgrid._INDEX_CACHE.clear()
    t_op = TOp.build(mesh.points, pts, order=2,
                     cfg=tconfig.LocateConfig(
                         nelem_to_search=20,
                         precision=tconfig.Precision.MIXED),
                     fallback="snap", device="cpu")
    assert len(tgrid._INDEX_CACHE) == 1  # the grid route ran
    got = t_op.apply(fields).numpy()
    assert got.shape == want.shape == (N, 3)
    assert t_op.found.all() and np.asarray(res.found).all()
    assert (t_op.elements.numpy() == np.asarray(res.elements)).mean() >= 0.95
    assert np.abs(got - want).max() <= 1e-5 * span
    truth = jmt.smooth_field(pts)
    assert np.abs(got[:, 0] / truth - 1).max() < 1e-3  # order 2, coarse

    carried = TOp.from_numpy(np.asarray(res.elements), np.asarray(res.refs),
                             np.asarray(res.found), 2, device="cpu")
    np.testing.assert_allclose(carried.apply(fields).numpy(), want,
                               rtol=1e-6, atol=1e-6 * span)
