"""K4 and K5 of the port (``search/polish.py``) on the CPU, where the
wrappers run their plain f64 twins: against the JAX package's df32
reference instantiations (``pallas_df32.polish_pairs_ref`` /
``apply_pairs_ref``) and against known answers.

The JAX references run under ``jax.disable_jit()``: jitted XLA:CPU
contracts mul + add into fma and breaks the df32 error-free transforms,
eager execution is exact (see ``tests/test_pallas_df32.py``).  The port's
twins compute in native f64, so both land within the pair's ~1e-12 floor
of the true refs and values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu.core import gll as jgll  # noqa: E402
from multimesh_tpu.search import pallas_df32 as pd32  # noqa: E402
from multimesh_tpu_torch.core import shape as tshape  # noqa: E402
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402
from multimesh_tpu_torch.search import polish  # noqa: E402
from tests.test_pallas_df32 import _build_geometry, _prep_split  # noqa: E402


def _polish_case(order, dim, M, seed, E=6):
    """Earth-scale curved elements, known refs, the points they map to
    (f64), and f32 warm starts 3e-6 off, as the f32 ladder leaves them.
    Returns (elem_nodes, ids, refs_true, points, ref0)."""
    rng = np.random.default_rng(seed)
    elem_nodes = _build_geometry(order, dim, E, rng)
    refs_true = rng.uniform(-0.95, 0.95, (M, dim))
    ids = rng.integers(0, E, M).astype(np.int32)
    points = tshape.forward_map(order, torch.from_numpy(elem_nodes[ids]),
                                torch.from_numpy(refs_true)).numpy()
    ref0 = (refs_true + rng.uniform(-3e-6, 3e-6, (M, dim))).astype(
        np.float32)
    return elem_nodes, ids, refs_true, points, ref0


def _port_args(elem_nodes, ids, points, ref0, order, dim):
    prep = tloc._mesh_prep(elem_nodes, order, "cpu", want64=True)
    return (torch.from_numpy(points), torch.from_numpy(ids),
            torch.from_numpy(ref0), prep.ctr, prep.inv_scale, prep.nodes64,
            order, dim)


@pytest.mark.parametrize("order,dim,M", [(4, 3, 64), (2, 3, 200),
                                         (4, 2, 200)])
def test_polish_twin_matches_jax_ref(order, dim, M):
    """One warm-started step: the port's f64 pair and the JAX df32 pair
    agree to 1e-10 with each other and with the true refs; ``ok`` is
    equal (True on every row: the steps are ~3e-6)."""
    elem_nodes, ids, refs_true, points, ref0 = _polish_case(order, dim, M,
                                                            seed=order + dim)
    hi, lo, ok = polish.polish_pairs_ref(
        *_port_args(elem_nodes, ids, points, ref0, order, dim), iters=1)
    got = hi.double().numpy() + lo.double().numpy()
    p_hi = points.astype(np.float32)
    p_lo = (points - p_hi.astype(np.float64)).astype(np.float32)
    with jax.disable_jit():
        j_hi, j_lo, j_ok = pd32.polish_pairs_ref(
            jnp.asarray(p_hi), jnp.asarray(p_lo), jnp.asarray(ids),
            jnp.asarray(ref0), *_prep_split(elem_nodes, order, dim),
            order=order, dim=dim, iters=1)
    want = np.asarray(j_hi, np.float64) + np.asarray(j_lo, np.float64)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert ok.all()
    assert np.abs(got - want).max() < 1e-10
    assert np.abs(got - refs_true).max() < 1e-10
    assert np.abs(ref0 - refs_true).max() > 1e-8  # the start was not


def test_polish_second_step_and_guard():
    """A second step keeps the converged ref; a warm start in the wrong
    element (steps far over 0.05) is flagged not ok, as is a NaN point,
    and a non-finite step leaves the ref finite."""
    order, dim = 4, 3
    elem_nodes, ids, refs_true, points, ref0 = _polish_case(order, dim, 40,
                                                            seed=7)
    args = list(_port_args(elem_nodes, ids, points, ref0, order, dim))
    hi1, lo1, ok1 = polish.polish_pairs_ref(*args, iters=1)
    hi2, lo2, ok2 = polish.polish_pairs_ref(*args, iters=2)
    e1 = np.abs(hi1.double().numpy() + lo1.double().numpy() - refs_true)
    e2 = np.abs(hi2.double().numpy() + lo2.double().numpy() - refs_true)
    assert ok1.all() and ok2.all() and e2.max() < 5 * max(e1.max(), 1e-12)
    bad = args[1].clone()
    bad[:10] = (bad[:10] + 3) % elem_nodes.shape[0]
    pts = args[0].clone()
    pts[10] = float("nan")
    hi, lo, ok = polish.polish_pairs_ref(pts, bad, *args[2:], iters=1)
    assert not ok[:11].any() and ok[11:].all()
    assert torch.isfinite(hi[:10]).all()


@pytest.mark.parametrize("order,dim,M", [(4, 3, 64), (4, 2, 260),
                                         (2, 3, 200)])
def test_apply_twin_matches_jax_ref_and_f64(order, dim, M):
    """Values at pair refs: the port's f64 twin against the JAX df32
    reference and against the f64 einsum, relative 1e-11; element -1
    gives 0."""
    rng = np.random.default_rng(20 + order + dim)
    elem_nodes = _build_geometry(order, dim, 5, rng)
    fields = np.stack([
        np.sin(elem_nodes[..., 0] / 2e5)
        + (0.3 + 0.1 * f) * np.cos(elem_nodes[..., dim - 1] / 3e5)
        for f in range(3)])  # [F, E, n]
    refs = rng.uniform(-0.999, 0.999, (M, dim))
    ids = rng.integers(0, 5, M).astype(np.int32)
    ref_hi = refs.astype(np.float32)
    ref_lo = (refs - ref_hi.astype(np.float64)).astype(np.float32)
    pair = ref_hi.astype(np.float64) + ref_lo
    w = np.asarray(jgll.tensor_basis(order, jnp.asarray(pair)))
    want = np.einsum("fmk,mk->mf", fields[:, ids, :], w)
    got = polish.apply_pairs(torch.from_numpy(ref_hi),
                             torch.from_numpy(ref_lo), torch.from_numpy(ids),
                             torch.from_numpy(fields), order, dim).numpy()
    rows_hi, rows_lo = pd32.prepare_field_rows(jnp.asarray(fields), order,
                                               dim)
    with jax.disable_jit():
        vh, vl = pd32.apply_pairs_ref(
            jnp.asarray(ref_hi), jnp.asarray(ref_lo),
            rows_hi[jnp.asarray(ids)], rows_lo[jnp.asarray(ids)],
            order=order, dim=dim, n_params=3)
    jax_vals = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)
    scale = np.maximum(np.abs(want), 1e-12)
    assert np.max(np.abs(got - want) / scale) < 1e-11
    assert np.max(np.abs(got - jax_vals) / scale) < 1e-11
    ids_missing = ids.copy()
    ids_missing[::7] = -1
    got_m = polish.apply_pairs(
        torch.from_numpy(ref_hi), torch.from_numpy(ref_lo),
        torch.from_numpy(ids_missing), torch.from_numpy(fields), order,
        dim).numpy()
    assert (got_m[::7] == 0).all()
    np.testing.assert_array_equal(got_m[ids_missing >= 0],
                                  got[ids_missing >= 0])


ORDER_DIMS = [(o, d) for o in polish.ORDERS for d in (2, 3)]


def _clustered_and_shuffled(M, seed, E=4):
    """Ids in runs of M // E rows per element, as the card's grouping
    leaves them, and a permutation of the rows (numpy)."""
    rng = np.random.default_rng(seed)
    return np.repeat(np.arange(E, dtype=np.int32), M // E), rng.permutation(M)


@pytest.mark.parametrize("order,dim", ORDER_DIMS)
def test_polish_row_order_contract(order, dim):
    """The row-order contract, on the CPU where ``polish_pairs`` runs its
    twin: on rows clustered by element, as the card's grouping leaves
    them, and on the same rows shuffled, it gives the same rows bit for
    bit, and both agree with the JAX df32 reference to 1e-10 (and with
    the true refs).  The grouped kernel is held to the same contract on
    the card (``test_torch_kernels_cuda.py``)."""
    E, M = 4, 256
    ids, shuffle = _clustered_and_shuffled(M, seed=50 + order + dim, E=E)
    rng = np.random.default_rng(60 + order + dim)
    elem_nodes = _build_geometry(order, dim, E, rng)
    refs_true = rng.uniform(-0.95, 0.95, (M, dim))
    points = tshape.forward_map(order, torch.from_numpy(elem_nodes[ids]),
                                torch.from_numpy(refs_true)).numpy()
    ref0 = (refs_true + rng.uniform(-3e-6, 3e-6, (M, dim))).astype(
        np.float32)
    got = polish.polish_pairs(
        *_port_args(elem_nodes, ids, points, ref0, order, dim), iters=1)
    got_s = polish.polish_pairs(
        *_port_args(elem_nodes, ids[shuffle], points[shuffle],
                    ref0[shuffle], order, dim), iters=1)
    for x, y in zip(got, got_s):
        assert torch.equal(x[torch.from_numpy(shuffle)], y)
    hi, lo, ok = got
    pair = hi.double().numpy() + lo.double().numpy()
    p_hi = points.astype(np.float32)
    p_lo = (points - p_hi.astype(np.float64)).astype(np.float32)
    with jax.disable_jit():
        j_hi, j_lo, j_ok = pd32.polish_pairs_ref(
            jnp.asarray(p_hi), jnp.asarray(p_lo), jnp.asarray(ids),
            jnp.asarray(ref0), *_prep_split(elem_nodes, order, dim),
            order=order, dim=dim, iters=1)
    want = np.asarray(j_hi, np.float64) + np.asarray(j_lo, np.float64)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
    assert ok.all()
    assert np.abs(pair - want).max() < 1e-10
    assert np.abs(pair - refs_true).max() < 1e-10


@pytest.mark.parametrize("order,dim", ORDER_DIMS)
def test_apply_row_order_contract(order, dim):
    """As for the polish, on the CPU's twin: ``apply_pairs`` on rows
    clustered by element and on the same rows shuffled gives the same
    rows bit for bit, and both agree with the JAX df32 reference to 1e-11
    relative (the grouped kernel: ``test_torch_kernels_cuda.py``)."""
    E, M = 4, 256
    ids, shuffle = _clustered_and_shuffled(M, seed=70 + order + dim, E=E)
    rng = np.random.default_rng(80 + order + dim)
    elem_nodes = _build_geometry(order, dim, E, rng)
    # kept away from 0, where a relative error means nothing
    fields = np.stack([
        2.0 + np.sin(elem_nodes[..., 0] / 2e5)
        + (0.3 + 0.1 * f) * np.cos(elem_nodes[..., dim - 1] / 3e5)
        for f in range(3)])  # [F, E, n]
    refs = rng.uniform(-0.999, 0.999, (M, dim))
    ref_hi = refs.astype(np.float32)
    ref_lo = (refs - ref_hi.astype(np.float64)).astype(np.float32)

    def apply(rows):
        return polish.apply_pairs(
            torch.from_numpy(ref_hi[rows]), torch.from_numpy(ref_lo[rows]),
            torch.from_numpy(ids[rows]), torch.from_numpy(fields), order,
            dim)

    got = apply(np.arange(M))
    assert torch.equal(got[torch.from_numpy(shuffle)], apply(shuffle))
    rows_hi, rows_lo = pd32.prepare_field_rows(jnp.asarray(fields), order,
                                               dim)
    with jax.disable_jit():
        vh, vl = pd32.apply_pairs_ref(
            jnp.asarray(ref_hi), jnp.asarray(ref_lo),
            rows_hi[jnp.asarray(ids)], rows_lo[jnp.asarray(ids)],
            order=order, dim=dim, n_params=3)
    want = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)
    scale = np.maximum(np.abs(want), 1e-12)
    assert np.max(np.abs(got.numpy() - want) / scale) < 1e-11


def test_twins_honour_the_bad_id_contract():
    """The twins give what the kernels give for ids outside [0, E): the
    polish NaN refs and not ok, the apply 0 for -1 and NaN for E."""
    order, dim = 2, 3
    elem_nodes, ids, _, points, ref0 = _polish_case(order, dim, 8, seed=9)
    args = list(_port_args(elem_nodes, ids, points, ref0, order, dim))
    E = elem_nodes.shape[0]
    args[1] = args[1].clone()
    args[1][:2] = torch.tensor([-1, E], dtype=torch.int32)
    hi, lo, ok = polish.polish_pairs(*args, iters=1)
    assert torch.isnan(hi[:2]).all() and torch.isnan(lo[:2]).all()
    assert not ok[:2].any() and ok[2:].all()
    fields = torch.ones((2, E, 27), dtype=torch.float64)
    vals = polish.apply_pairs(hi[2:5], lo[2:5], torch.tensor(
        [-1, E, 0], dtype=torch.int32), fields, order, dim)
    assert (vals[0] == 0).all() and torch.isnan(vals[1]).all()
    assert torch.allclose(vals[2], torch.ones(2, dtype=torch.float64))


def test_wrappers_run_the_twins_on_cpu():
    """CPU tensors run the twins (identical results, no launch counted)."""
    order, dim = 2, 3
    elem_nodes, ids, _, points, ref0 = _polish_case(order, dim, 50, seed=3)
    args = _port_args(elem_nodes, ids, points, ref0, order, dim)
    n0 = polish.polish_pairs.launches
    for x, y in zip(polish.polish_pairs(*args, iters=1),
                    polish.polish_pairs_ref(*args, iters=1)):
        assert torch.equal(x, y)
    assert polish.polish_pairs.launches == n0


def test_wrappers_refuse_bad_arguments():
    """Wrong dtype, shape or device raises before anything runs."""
    order, dim = 2, 3
    elem_nodes, ids, _, points, ref0 = _polish_case(order, dim, 8, seed=5)
    args = list(_port_args(elem_nodes, ids, points, ref0, order, dim))
    for i, bad in ((0, args[0].float()), (1, args[1].long()),
                   (2, args[2][:4]), (5, args[5].float())):
        wrong = list(args)
        wrong[i] = bad
        with pytest.raises(ValueError):
            polish.polish_pairs(*wrong, iters=1)
    with pytest.raises(ValueError, match="device"):
        polish.polish_pairs(*(a.to("meta") if torch.is_tensor(a) else a
                              for a in args), iters=1)
    fields = torch.zeros((2, elem_nodes.shape[0], 27), dtype=torch.float64)
    hi = torch.zeros((8, 3), dtype=torch.float32)
    el = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        polish.apply_pairs(hi, hi, el, fields.float(), order, dim)
    with pytest.raises(ValueError):
        polish.apply_pairs(hi, hi[:, :2], el, fields, order, dim)
    with pytest.raises(ValueError, match="device"):
        polish.apply_pairs(hi.to("meta"), hi.to("meta"), el.to("meta"),
                           fields.to("meta"), order, dim)
