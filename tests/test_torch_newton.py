"""K1, the Newton rows kernel: its plain PyTorch twin against the JAX
Pallas kernel ``newton_refs_rows`` in interpret mode, and the device
policy of its wrapper.

Both sides get the same rows, built once in numpy from one lattice: the
JAX kernel in its own ``[C, Fp]`` / ``[d, C/128, 128]`` layout, the port
as ``points [M, d]`` f64 + element ids + the per-element f64 centre and
inverse scale + the f32 unit-frame lattice ``[E, n*d]``.  The point is
centred in f64 and cast to f32 on both sides, so the inputs are bitwise
the same and only the f32 arithmetic order differs (the twin sums over
the lattice with ``torch.sum``, the Pallas interpreter term by term).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from multimesh_tpu.search import pallas_newton as jpn  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch.search import newton as tnewton  # noqa: E402
from multimesh_tpu_torch.search.locate import _mesh_prep  # noqa: E402

CONV_TOL = 1e-4  # the ladder's f32 convergence threshold (residual)
ITERS = 18  # newton_iters + polish_iters of the default LocateConfig


def _rows(order, dim, C=1024, seed=0):
    """C (point, element) rows on a warped mesh: 90% rows whose element
    is the nearest centroid (they converge inside or next to it), 10%
    random elements (far away: Newton diverges and clamps)."""
    shape = (3, 3, 3) if dim == 3 else (5, 5)
    mesh = tmt.box_mesh(shape=shape, order=order, warp=0.15,
                        extent=[(-3e3, 2e3)] * dim)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3e3, 2e3, (C, dim))
    cent = mesh.centroids()
    ids = np.argmin(((pts[:, None] - cent[None]) ** 2).sum(-1), axis=1)
    wild = rng.random(C) < 0.1
    ids[wild] = rng.integers(0, mesh.nelem, wild.sum())
    prep = _mesh_prep(mesh.points, order, "cpu")
    return pts, ids.astype(np.int32), prep


def _jax_rows(pts, ids, prep, order, dim):
    """The JAX kernel's own inputs for the same rows."""
    ctr = prep.ctr.numpy()
    inv = prep.inv_scale.numpy()
    p_c = ((pts - ctr[ids]) * inv[ids, None]).astype(np.float32)
    C = pts.shape[0]
    Fp = jpn._rows_feature_pad(order, dim)
    rows = np.zeros((C, Fp), np.float32)
    nodes = prep.nodes.numpy()
    rows[:, : nodes.shape[1]] = nodes[ids]
    p_t = p_c.T.reshape(dim, C // 128, 128)
    refs_t, res_t = jpn.newton_refs_rows(
        jnp.asarray(rows), jnp.asarray(p_t), order, dim, iters=ITERS,
        clamp=8.0, interpret=True)
    refs = np.asarray(refs_t).reshape(dim, C).T
    return refs, np.asarray(res_t).reshape(C)


def _twin(pts, ids, prep, order, dim):
    return tnewton.newton_refs_rows_ref(
        torch.from_numpy(pts), torch.from_numpy(ids), prep.ctr,
        prep.inv_scale, prep.nodes, order, dim, ITERS, 8.0)


# 5/3 to 7/3 take minutes in interpret mode: test_torch_orders.py and
# test_torch_newton_order7.py
@pytest.mark.parametrize("order,dim", [(1, 2), (1, 3), (2, 2), (2, 3),
                                       (4, 3), (3, 2), (3, 3), (5, 2),
                                       (6, 2), (7, 2)])
def test_twin_matches_pallas_interpret(order, dim):
    """What the ladder reads must agree exactly: acceptance (res < 1e-4
    and max |ref| < 1.05) on every row, and the accepted refs to 1e-5
    (the f32 Newton plateau is ~1e-6 in the unit frame).

    Convergence alone may flip on rows that converge far outside their
    element (|ref| 2-5, the random-element rows): there the f32 residual
    plateau grows with |ref|^order up to the 1e-4 threshold, so the
    summation order decides (measured 1% of rows at order 4).  Those
    extrapolated refs agree to 1e-3 relative where both converge."""
    pts, ids, prep = _rows(order, dim, seed=order * 10 + dim)
    want_ref, want_res = _jax_rows(pts, ids, prep, order, dim)
    got_ref, got_res = _twin(pts, ids, prep, order, dim)
    got_ref, got_res = got_ref.numpy(), got_res.numpy()
    assert got_ref.dtype == np.float32 and got_res.dtype == np.float32
    cw, cg = want_res < CONV_TOL, got_res < CONV_TOL
    aw = cw & (np.abs(want_ref).max(-1) < 1.05)
    ag = cg & (np.abs(got_ref).max(-1) < 1.05)
    np.testing.assert_array_equal(ag, aw)
    assert ag.mean() > 0.8
    np.testing.assert_allclose(got_ref[ag], want_ref[ag], atol=1e-5)
    assert (cw == cg).mean() >= 0.98
    both = cw & cg
    np.testing.assert_allclose(got_ref[both], want_ref[both], rtol=1e-3,
                               atol=1e-5)
    # every iterate stays within the clamp, converged or not
    assert np.abs(got_ref).max() <= 8.0


def _cpu_args(order=2, dim=3):
    pts, ids, prep = _rows(order, dim, C=256, seed=5)
    return (torch.from_numpy(pts), torch.from_numpy(ids), prep.ctr,
            prep.inv_scale, prep.nodes, order, dim, ITERS, 8.0)


def test_wrapper_runs_twin_on_cpu_without_launching():
    """A CPU tensor takes the plain twin -- bitwise its output -- and the
    launch count stays put (it counts kernel launches only)."""
    args = _cpu_args()
    before = tnewton.newton_rows.launches
    ref, res = tnewton.newton_rows(*args)
    twin_ref, twin_res = tnewton.newton_refs_rows_ref(*args)
    assert tnewton.newton_rows.launches == before
    assert torch.equal(ref, twin_ref) and torch.equal(res, twin_res)


@pytest.mark.parametrize("bad", ["ids_dtype", "points_dtype", "nodes_shape",
                                 "contiguity", "dim", "device_mix"])
def test_wrapper_rejects_bad_arguments(bad):
    """Shape, dtype, contiguity and device are checked before any launch."""
    args = list(_cpu_args())
    if bad == "ids_dtype":
        args[1] = args[1].long()
    elif bad == "points_dtype":
        args[0] = args[0].float()
    elif bad == "nodes_shape":
        args[4] = args[4][:, :-3].contiguous()
    elif bad == "contiguity":
        args[0] = torch.cat([args[0], args[0]], dim=1)[:, ::2]
    elif bad == "dim":
        args[6] = 4
    else:
        args[2] = args[2].to("meta")
    with pytest.raises(ValueError):
        tnewton.newton_rows(*args)


def test_wrapper_refuses_other_devices():
    """Neither CPU nor CUDA: raise, never fall back to the twin."""
    args = [a.to("meta") if torch.is_tensor(a) else a for a in _cpu_args()]
    with pytest.raises(ValueError, match="unsupported device"):
        tnewton.newton_rows(*args)


def test_group_rows_orders_by_element():
    """``group_rows`` is a permutation under which the in-range ids are
    non-decreasing, rows of one element keep their order, and the ids out
    of range (-1, E and beyond) all come last."""
    E = 50
    rng = np.random.default_rng(7)
    ids = rng.integers(0, E, 5000).astype(np.int32)
    ids[rng.random(5000) < 0.05] = -1
    ids[rng.random(5000) < 0.05] = E
    ids[:3] = (E + 7, -5, E)
    perm = tnewton.group_rows(torch.from_numpy(ids), E).numpy()
    assert perm.dtype == np.int32
    np.testing.assert_array_equal(np.sort(perm), np.arange(ids.size))
    got = ids[perm]
    bad = (got < 0) | (got >= E)
    n_ok = int((~bad).sum())
    assert not bad[:n_ok].any() and bad[n_ok:].all()
    assert (np.diff(got[:n_ok]) >= 0).all()
    for e in (0, 17, E - 1):  # stable: rows of one element in row order
        rows = perm[got == e]
        assert (np.diff(rows) > 0).all()
    assert tnewton.group_rows(torch.from_numpy(ids[:0]), E).shape == (0,)


def _grouped_twin(args):
    """The kernel's schedule run with the twin: rows visited in
    ``group_rows`` order, each result written back at its own row; an
    out-of-range id gives NaN refs and residual."""
    points, ids = args[0], args[1]
    E, dim = args[2].shape[0], args[6]
    perm = tnewton.group_rows(ids, E)
    valid = (ids[perm] >= 0) & (ids[perm] < E)
    rows = perm[valid]
    refs = torch.full((ids.shape[0], dim), float("nan"))
    res = torch.full((ids.shape[0],), float("nan"))
    g_ref, g_res = tnewton.newton_refs_rows_ref(
        points[rows].contiguous(), ids[rows].contiguous(), *args[2:])
    refs[rows], res[rows] = g_ref, g_res
    return refs, res


@pytest.mark.parametrize("case", ["1/2", "1/3", "2/2", "2/3", "4/2", "4/3",
                                  "shuffled", "one_element", "bad_ids"])
def test_grouped_order_equals_row_order(case):
    """The twin run through the grouped order and written back equals the
    twin run in row order bit for bit (each row's solve depends on its
    own row only); the rows of ids -1 and E give NaN."""
    order, dim = ((int(case[0]), int(case[2])) if "/" in case else (2, 3))
    pts, ids, prep = _rows(order, dim, C=512, seed=order * 10 + dim)
    rng = np.random.default_rng(3)
    if case == "shuffled":
        p = rng.permutation(ids.size)
        pts, ids = pts[p].copy(), ids[p].copy()
    elif case == "one_element":
        ids[:] = 4
    bad = np.zeros(ids.size, bool)
    if case == "bad_ids":
        bad = rng.random(ids.size) < 0.1
        ids[bad] = np.where(rng.random(int(bad.sum())) < 0.5, -1,
                            prep.ctr.shape[0])
    args = (torch.from_numpy(pts), torch.from_numpy(ids), prep.ctr,
            prep.inv_scale, prep.nodes, order, dim, ITERS, 8.0)
    g_ref, g_res = _grouped_twin(args)
    ok = torch.from_numpy(~bad)
    w_ref, w_res = tnewton.newton_refs_rows_ref(
        args[0][ok].contiguous(), args[1][ok].contiguous(), *args[2:])
    assert torch.equal(g_ref[ok], w_ref) and torch.equal(g_res[ok], w_res)
    nb = torch.from_numpy(bad)
    assert torch.isnan(g_ref[nb]).all() and torch.isnan(g_res[nb]).all()
