"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Every test here carries the ``cuda`` marker and skips without a
CUDA device (so on a CPU-only machine they count as skips, not passes).

This file imports only torch and the port -- no JAX -- so it runs on a
machine without JAX; ``tests/conftest.py`` imports JAX, so run it there
with ``--noconftest``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu_torch import TransferOperator, _build, testing  # noqa: E402
from multimesh_tpu_torch import hashing  # noqa: E402
from multimesh_tpu_torch import utils_profile  # noqa: E402
from multimesh_tpu_torch.config import LocateConfig  # noqa: E402
from multimesh_tpu_torch.core import shape  # noqa: E402
from multimesh_tpu_torch.ops import dedup as tdedup  # noqa: E402
from multimesh_tpu_torch.search import grid as tgrid  # noqa: E402
from multimesh_tpu_torch.search import knn as tknn  # noqa: E402
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402
from multimesh_tpu_torch.search import nearest, newton, polish  # noqa: E402

pytestmark = pytest.mark.cuda
# every (order, dim) pair K1, K4 and K5 are built for
ORDER_DIMS = [(o, d) for o in newton.ORDERS for d in (2, 3)]


@pytest.fixture
def dev():
    """The card; decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("d", [2, 3])
def test_nearest_kernel_matches_twin(dev, d):
    """Picks of K2 and the twin: identical on >= 99.9% of queries and
    distance-equivalent within the f32 score's rounding band."""
    rng = np.random.default_rng(d)
    src = torch.as_tensor(rng.uniform(-3e6, 3e6, (3000, d)), device=dev)
    q = torch.as_tensor(rng.uniform(-3e6, 3e6, (50_000, d)), device=dev)
    before = nearest.nearest.launches
    got = nearest.nearest(q, src)
    assert nearest.nearest.launches == before + 1
    want = nearest.nearest_centroid_ref(q, src)
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert (got == want).double().mean() >= 0.999
    dg = ((q - src[got.long()]) ** 2).sum(-1)
    dw = ((q - src[want.long()]) ** 2).sum(-1)
    # a few f32 ulp of |q|^2 + |c|^2 (centred): the score's rounding
    center = src.mean(dim=0)
    band = 4 * 2.0 ** -24 * float(((q - center) ** 2).sum(-1).max()
                                  + ((src - center) ** 2).sum(-1).max())
    assert float(((dg - dw).abs() - 1e-5 * dw).max()) <= band


def test_nearest_kernel_small_and_tied(dev):
    """Fewer sources than a tile, more queries than a block, and exact
    ties resolved to the lower index."""
    src = torch.tensor([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [1.0, 0.0, 0.0]],
                       dtype=torch.float64, device=dev)
    q = torch.tensor([[1.1, 0.0, 0.0], [0.9, 0.1, 0.0]] * 300,
                     dtype=torch.float64, device=dev)
    assert (nearest.nearest(q, src) == 0).all()


@pytest.mark.parametrize("order,dim", ORDER_DIMS)
def test_newton_kernel_matches_twin(dev, order, dim):
    """K1 against the twin on 20,000 rows (nearest-centroid elements plus
    10% random ones): acceptance agrees on >= 99.9% of rows and accepted
    refs to 1e-5; the launch count moves by one."""
    shape = (6, 6, 6) if dim == 3 else (20, 20)
    mesh = testing.box_mesh(shape=shape, order=order, warp=0.15)
    prep = tloc._mesh_prep(mesh.points, order, dev)
    rng = np.random.default_rng(order * 10 + dim)
    pts = torch.as_tensor(rng.uniform(0, 1, (20_000, dim)), device=dev)
    ids = nearest.nearest_centroid_ref(pts, prep.centroids)
    wild = torch.as_tensor(rng.random(20_000) < 0.1, device=dev)
    rand = torch.as_tensor(rng.integers(0, mesh.nelem, 20_000,
                                        dtype=np.int32), device=dev)
    ids = torch.where(wild, rand, ids).contiguous()
    args = (pts, ids, prep.ctr, prep.inv_scale, prep.nodes, order, dim, 18,
            8.0)
    before = newton.newton_rows.launches
    k_ref, k_res = newton.newton_rows(*args)
    assert newton.newton_rows.launches == before + 1
    p_ref, p_res = newton.newton_refs_rows_ref(*args)
    ka = (k_res < 1e-4) & (k_ref.abs().amax(-1) < 1.05)
    pa = (p_res < 1e-4) & (p_ref.abs().amax(-1) < 1.05)
    assert (ka == pa).double().mean() >= 0.999
    both = ka & pa
    assert both.double().mean() > 0.8
    assert float((k_ref - p_ref)[both].abs().max()) <= 1e-5


def _newton_args(dev, order, dim, M, seed, shape_=None):
    """M rows on a warped box mesh: nearest-centroid elements, 10% random."""
    shape_ = shape_ or ((6, 6, 6) if dim == 3 else (20, 20))
    mesh = testing.box_mesh(shape=shape_, order=order, warp=0.15)
    prep = tloc._mesh_prep(mesh.points, order, dev)
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.uniform(0, 1, (M, dim)), device=dev)
    ids = nearest.nearest_centroid_ref(pts, prep.centroids)
    wild = torch.as_tensor(rng.random(M) < 0.1, device=dev)
    rand = torch.as_tensor(rng.integers(0, mesh.nelem, M, dtype=np.int32),
                           device=dev)
    ids = torch.where(wild, rand, ids).contiguous()
    return [pts, ids, prep.ctr, prep.inv_scale, prep.nodes, order, dim, 18,
            8.0]


@pytest.mark.parametrize("case", ["random", "one_element", "bad_ids",
                                  "empty"])
def test_group_rows_kernel_is_a_grouping(dev, case):
    """The counting sort gives a permutation under which the ids are
    non-decreasing and the out-of-range ones (-1, E and beyond) come last,
    as the twin's does; it may order the rows of one element otherwise."""
    E, M = 3000, 0 if case == "empty" else 200_003
    rng = np.random.default_rng(1)
    ids = rng.integers(0, E, M).astype(np.int32)
    if case == "one_element":
        ids[:] = 17
    elif case == "bad_ids":
        ids[rng.random(M) < 0.1] = -1
        ids[rng.random(M) < 0.1] = E
        ids[:2] = (-7, E + 9)
    ids_d = torch.as_tensor(ids, device=dev)
    perm = newton.group_rows(ids_d, E)
    assert perm.dtype == torch.int32 and perm.shape == (M,)
    assert torch.equal(torch.sort(perm.long()).values,
                       torch.arange(M, device=dev))
    want = newton.group_rows_ref(ids_d, E)
    key = torch.where((ids_d >= 0) & (ids_d < E), ids_d, E)
    assert torch.equal(key[perm.long()], key[want.long()])


@pytest.mark.parametrize("rows", ["shuffled", "presorted"])
def test_newton_kernel_grouped_rows_match_twin(dev, rows):
    """K1 groups the rows by element and writes each result back at its
    own row: on shuffled rows and on rows already sorted by element, the
    results equal the twin's row for row (acceptance on >= 99.9%,
    accepted refs to 1e-5), and are bitwise the same as on the same rows
    in another order."""
    args = _newton_args(dev, 4, 3, 30_000, seed=5)
    if rows == "presorted":
        order_ = torch.sort(args[1], stable=True).indices
    else:
        order_ = torch.randperm(30_000, device=dev)
    args[0] = args[0][order_].contiguous()
    args[1] = args[1][order_].contiguous()
    k_ref, k_res = newton.newton_rows(*args)
    p_ref, p_res = newton.newton_refs_rows_ref(*args)
    ka = (k_res < 1e-4) & (k_ref.abs().amax(-1) < 1.05)
    pa = (p_res < 1e-4) & (p_ref.abs().amax(-1) < 1.05)
    assert (ka == pa).double().mean() >= 0.999
    both = ka & pa
    assert both.double().mean() > 0.8
    assert float((k_ref - p_ref)[both].abs().max()) <= 1e-5
    back = torch.argsort(order_)
    r_ref, r_res = newton.newton_rows(args[0][back].contiguous(),
                                      args[1][back].contiguous(), *args[2:])
    assert torch.equal(r_ref[order_], k_ref)
    assert torch.equal(r_res[order_], k_res)


@pytest.mark.parametrize("order,dim", [(4, 3), (2, 3)])
def test_newton_kernel_slot_overflow_matches_slotted(dev, order, dim):
    """Rows whose element finds no shared-memory slot read the lattice
    from global memory with the same arithmetic: one row per element (128
    distinct elements a block, past every slot cap), and the kernel
    driven through an identity permutation on shuffled rows, give
    bitwise the results of the grouped launch; and match the twin."""
    args = _newton_args(dev, order, dim, 20_000, seed=7,
                        shape_=(12, 12, 12))
    E = args[2].shape[0]  # 1,728 elements
    k_ref, k_res = newton.newton_rows(*args)
    # identity order: a block of 128 shuffled rows meets ~120 elements
    pts, ids = args[0], args[1]
    refs = torch.empty_like(k_ref)
    res = torch.empty_like(k_res)
    ident = torch.arange(pts.shape[0], dtype=torch.int32, device=dev)
    lib = _build.library()
    err = lib.mmt_newton_rows(
        pts.data_ptr(), ids.data_ptr(), ident.data_ptr(),
        args[2].data_ptr(), args[3].data_ptr(), args[4].data_ptr(),
        pts.shape[0], E, order, dim, 18, 8.0, refs.data_ptr(),
        res.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "newton_rows")
    torch.cuda.synchronize()
    assert torch.equal(refs, k_ref) and torch.equal(res, k_res)
    # one row per element
    one = torch.arange(E, dtype=torch.int32, device=dev)
    o_pts = args[2].clone()  # element centres: inside every element
    o_ref, o_res = newton.newton_rows(o_pts, one, *args[2:])
    p_ref, p_res = newton.newton_refs_rows_ref(o_pts, one, *args[2:])
    ka = (o_res < 1e-4) & (o_ref.abs().amax(-1) < 1.05)
    pa = (p_res < 1e-4) & (p_ref.abs().amax(-1) < 1.05)
    assert torch.equal(ka, pa) and ka.double().mean() >= 0.99
    assert float((o_ref - p_ref)[ka].abs().max()) <= 1e-5


def test_newton_kernel_bad_ids_give_nan(dev):
    """An out-of-range element id reads nothing: NaN refs and residual,
    never accepted."""
    mesh = testing.box_mesh(shape=(2, 2, 2), order=2)
    prep = tloc._mesh_prep(mesh.points, 2, dev)
    pts = torch.full((3, 3), 0.5, dtype=torch.float64, device=dev)
    ids = torch.tensor([0, -1, 8], dtype=torch.int32, device=dev)
    ref, res = newton.newton_rows(pts, ids, prep.ctr, prep.inv_scale,
                                  prep.nodes, 2, 3, 18, 8.0)
    assert torch.isfinite(ref[0]).all() and float(res[0]) < 1e-4
    assert torch.isnan(res[1:]).all() and torch.isnan(ref[1:]).all()


@pytest.mark.parametrize("E,C", [(1, 700), (1100, 5000), (3000, 4097)])
def test_nearest_kernel_ragged_tiles_and_ties(dev, E, C):
    """K2 where E is not a multiple of the 1,024-source tile nor of the
    16-source group, where C is not a multiple of a block's 512 queries,
    with E = 1, and with an exact duplicate of a source in a later tile:
    the picks match the twin's on >= 99.9% of queries, and queries next
    to the duplicated source pick its lower index."""
    rng = np.random.default_rng(E)
    src = rng.uniform(-3e6, 3e6, (E, 3))
    q = rng.uniform(-3e6, 3e6, (C, 3))
    if E > 1:
        src[E - 1] = src[3]  # the last source, in a later tile, copies 3
        q[:40] = src[3] + 10.0
    src_d, q_d = torch.as_tensor(src, device=dev), torch.as_tensor(q,
                                                                   device=dev)
    got = nearest.nearest(q_d, src_d)
    want = nearest.nearest_centroid_ref(q_d, src_d)
    assert got.dtype == torch.int32 and got.shape == (C,)
    if E == 1:
        assert (got == 0).all()
        return
    assert (got[:40] == 3).all()
    assert (got == want).double().mean() >= 0.999


def test_wrappers_refuse_cpu_cuda_mix(dev):
    """Tensors on two devices are refused before any launch."""
    mesh = testing.box_mesh(shape=(2, 2, 2), order=1)
    prep = tloc._mesh_prep(mesh.points, 1, dev)
    pts = torch.full((4, 3), 0.5, dtype=torch.float64)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        newton.newton_rows(pts, ids, prep.ctr, prep.inv_scale, prep.nodes,
                           1, 3, 18, 8.0)
    with pytest.raises(ValueError):
        nearest.nearest(pts, prep.centroids)
    prep64 = tloc._mesh_prep(mesh.points, 1, dev, want64=True)
    with pytest.raises(ValueError):
        polish.polish_pairs(pts, ids, pts.float(), prep64.ctr,
                            prep64.inv_scale, prep64.nodes64, 1, 3, 1)
    fields = torch.zeros((1, mesh.nelem, 8), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        polish.apply_pairs(pts.float(), pts.float(), ids, fields, 1, 3)


def test_transfer_on_card_matches_plain_path(dev):
    """build + apply through the kernels against the same call through
    the twins on the card: elements agree on >= 99.9% of targets and
    values to rtol 1e-5; both kernels were launched."""
    src = testing.shell_mesh(n_lat=8, n_lon=8, n_rad=8, order=4)  # E = 512
    pts = torch.as_tensor(testing.shell_targets(100_000, seed=3), device=dev)
    base = testing.element_nodal_field(src, "smooth")
    fields = torch.as_tensor(np.stack([base, 2 * base]), device=dev)
    n0, k0 = newton.newton_rows.launches, nearest.nearest.launches
    op = TransferOperator.build(src.points, pts, order=4, fallback="snap",
                                device=dev)
    assert newton.newton_rows.launches > n0 and nearest.nearest.launches > k0
    plain = TransferOperator.build(src.points, pts, order=4,
                                   fallback="snap", device=dev, plain=True)
    same = op.elements == plain.elements
    assert same.double().mean() >= 0.999
    v, pv = op.apply(fields), plain.apply(fields)
    assert float(((v - pv).abs() / pv.abs())[same].max()) <= 1e-5
    truth = torch.as_tensor(testing.smooth_field(pts.cpu().numpy()),
                            device=dev)
    assert float(((v[:, 0].double() - truth).abs() / truth).max()) < 1e-4


def test_scan_retry_on_card_matches_plain_path(dev):
    """Exterior targets overflow the rescue buckets, so the scan retry
    (K1 once per candidate column) runs on the card; the kernel path and
    the plain path agree on found rows and, where elements agree (>= 99%:
    snapped exterior rows may pick another boundary element), on
    accepted values to rtol 1e-5."""
    src = testing.shell_mesh(n_lat=6, n_lon=6, n_rad=6, order=4)  # E = 216
    pts = testing.shell_targets(20_000, seed=8)
    pts[:5_000] *= 1.5  # beyond the shell where 1.5 r > r_outer
    pts = torch.as_tensor(pts, device=dev)
    fields = torch.as_tensor(testing.element_nodal_field(src, "smooth"),
                             device=dev)
    res = tloc.locate(pts, src.points, 4, fallback="sentinel", device=dev)
    plain = tloc.locate(pts, src.points, 4, fallback="sentinel", device=dev,
                        plain=True)
    assert res.n_retry > 0 and plain.n_retry > 0
    assert (res.found == plain.found).double().mean() >= 0.9999
    same = res.found & plain.found & (res.elements == plain.elements)
    assert same.double().mean() >= 0.99 * float(res.found.double().mean())
    op = TransferOperator(res.elements, 4, res.refs, res.found)
    pop = TransferOperator(plain.elements, 4, plain.refs, plain.found)
    v, pv = op.apply(fields), pop.apply(fields)
    assert float(((v - pv).abs() / pv.abs().clamp_min(1e-30))[same].max()) \
        <= 1e-5


def _row_ids(rng, nelem, M, distinct):
    """M element ids: random, or with ``distinct`` no two the same."""
    if distinct:
        return rng.permutation(nelem)[:M].astype(np.int32)
    return rng.integers(0, nelem, M, dtype=np.int32)


def _polish_rows(dev, order, dim, M, seed, shape_=None, distinct=False):
    """Known refs in a warped box mesh, the f64 points they map to, and
    f32 warm starts 3e-6 off: the polish's arguments and the true refs.
    With ``distinct`` every row has an element of its own (M of the
    mesh's elements, shuffled)."""
    shape_ = shape_ or ((6, 6, 6) if dim == 3 else (20, 20))
    mesh = testing.box_mesh(shape=shape_, order=order, warp=0.15)
    prep = tloc._mesh_prep(mesh.points, order, dev, want64=True)
    rng = np.random.default_rng(seed)
    refs = torch.as_tensor(rng.uniform(-0.95, 0.95, (M, dim)), device=dev)
    ids = torch.as_tensor(_row_ids(rng, mesh.nelem, M, distinct), device=dev)
    nodes = torch.as_tensor(mesh.points, device=dev)[ids.long()]
    pts = shape.forward_map(order, nodes, refs).contiguous()
    ref0 = (refs + torch.as_tensor(rng.uniform(-3e-6, 3e-6, (M, dim)),
                                   device=dev)).float().contiguous()
    return (pts, ids, ref0, prep.ctr, prep.inv_scale, prep.nodes64, order,
            dim), refs


@pytest.mark.parametrize("order,dim", ORDER_DIMS)
def test_polish_kernel_matches_twin(dev, order, dim):
    """K4 against its twin on 20,000 rows: ok agrees everywhere, hi + lo
    to 1e-11, and both within 1e-10 of the known refs; one launch."""
    args, refs = _polish_rows(dev, order, dim, 20_000, seed=order + dim)
    before = polish.polish_pairs.launches
    hi, lo, ok = polish.polish_pairs(*args, 1)
    assert polish.polish_pairs.launches == before + 1
    p_hi, p_lo, p_ok = polish.polish_pairs_ref(*args, 1)
    assert torch.equal(ok, p_ok) and ok.all()
    got, want = hi.double() + lo.double(), p_hi.double() + p_lo.double()
    assert float((got - want).abs().max()) <= 1e-11
    assert float((got - refs).abs().max()) < 1e-10


def test_polish_kernel_bad_ids_give_nan(dev):
    """An out-of-range element id reads nothing: NaN refs, ok False; a
    warm start in the wrong element is not ok."""
    args, _ = _polish_rows(dev, 2, 3, 6, seed=1)
    ids = args[1].clone()
    ids[0], ids[1] = -1, 6 ** 3
    ids[2] = (ids[2] + 7) % 6 ** 3
    hi, lo, ok = polish.polish_pairs(args[0], ids, *args[2:], 1)
    assert torch.isnan(hi[:2]).all() and torch.isnan(lo[:2]).all()
    assert not ok[:3].any() and ok[3:].all()


def _bits(t):
    """The tensor's bits, so that equal NaNs compare equal."""
    kind = {torch.float32: torch.int32, torch.float64: torch.int64}
    return t.view(kind.get(t.dtype, t.dtype))


def _row_order(dev, ids, rows):
    """A row order: ``presorted`` by element or ``shuffled``."""
    if rows == "presorted":
        return torch.sort(ids, stable=True).indices
    return torch.randperm(ids.shape[0], device=dev)


@pytest.mark.parametrize("rows", ["shuffled", "presorted"])
@pytest.mark.parametrize("order,dim", ORDER_DIMS)
def test_polish_kernel_grouped_rows_match_twin(dev, order, dim, rows):
    """K4 on grouped rows (20,003 of them: not a multiple of a block,
    ids -1 and E among them), shuffled or presorted by element: ok equal
    to the twin's on every row, hi + lo to 1e-11 and within 1e-10 of the
    known refs, NaN where the id is bad; the same rows in another order
    give bitwise the permuted results."""
    args, refs = _polish_rows(dev, order, dim, 20_003, seed=order * dim)
    args = list(args)
    E = args[3].shape[0]
    args[1][:6] = torch.tensor([-1, E, -1, E, E + 5, -1], dtype=torch.int32)
    order_ = _row_order(dev, args[1], rows)
    args[0], args[1], args[2] = (a[order_].contiguous() for a in args[:3])
    refs = refs[order_]
    bad = (args[1] < 0) | (args[1] >= E)
    hi, lo, ok = polish.polish_pairs(*args, 1)
    p_hi, p_lo, p_ok = polish.polish_pairs_ref(*args, 1)
    assert torch.equal(ok, p_ok) and torch.equal(ok, ~bad)
    assert torch.isnan(hi[bad]).all() and torch.isnan(lo[bad]).all()
    got, want = hi.double() + lo.double(), p_hi.double() + p_lo.double()
    assert float((got - want)[~bad].abs().max()) <= 1e-11
    assert float((got - refs)[~bad].abs().max()) < 1e-10
    back = torch.argsort(order_)
    again = polish.polish_pairs(*(a[back].contiguous() for a in args[:3]),
                                *args[3:], 1)
    for x, y in zip(again, (hi, lo, ok)):
        assert torch.equal(_bits(x[order_]), _bits(y))


@pytest.mark.parametrize("order,dim", [(4, 3), (2, 3)])
def test_polish_kernel_slot_overflow_matches_slotted(dev, order, dim):
    """Rows whose element finds no shared-memory slot read the lattice
    from global memory with the same arithmetic: K4 driven through the
    identity permutation on random rows of 1,728 elements (~120 distinct
    elements a block, past the 10 or 50 slots) gives bitwise the grouped
    launch's results."""
    args, refs = _polish_rows(dev, order, dim, 20_000, seed=11,
                              shape_=(12, 12, 12))
    grouped = polish.polish_pairs(*args, 1)
    ident = torch.arange(20_000, dtype=torch.int32, device=dev)
    plain_order = polish._polish_kernel(ident, *args, 1)
    torch.cuda.synchronize()
    for x, y in zip(plain_order, grouped):
        assert torch.equal(_bits(x), _bits(y))
    assert grouped[2].all()
    assert float((grouped[0].double() + grouped[1].double() - refs)
                 .abs().max()) < 1e-10


def _apply_rows(dev, order, dim, M, F, seed, shape_=None, distinct=False):
    """Random pair refs in random elements of a warped box mesh (with
    ``distinct`` no two rows in one element) and F smooth fields:
    apply_pairs' arguments."""
    shape_ = shape_ or ((6, 6, 6) if dim == 3 else (20, 20))
    mesh = testing.box_mesh(shape=shape_, order=order, warp=0.15)
    rng = np.random.default_rng(seed)
    base = testing.smooth_field(mesh.points)
    fields = torch.as_tensor(np.stack([base * (1 + 0.1 * f) + f
                                       for f in range(F)]), device=dev)
    refs = rng.uniform(-1, 1, (M, dim))
    hi = torch.as_tensor(refs.astype(np.float32), device=dev)
    lo = (torch.as_tensor(refs, device=dev) - hi.double()).float()
    el = torch.as_tensor(_row_ids(rng, mesh.nelem, M, distinct), device=dev)
    return [hi, lo, el, fields, order, dim]


@pytest.mark.parametrize("rows", ["shuffled", "presorted"])
@pytest.mark.parametrize("F", [1, 7])
def test_apply_kernel_grouped_rows_match_twin(dev, F, rows):
    """K5 on grouped rows (50,001 of them, ids -1 and E among them),
    shuffled or presorted by element, F = 1 or 7 parameters: relative
    1e-12 to the twin, 0 for -1 and NaN for E; the same rows in another
    order give bitwise the permuted results."""
    args = _apply_rows(dev, 4, 3, 50_001, F, seed=F)
    E = args[3].shape[1]
    args[2][::97] = -1
    args[2][5::101] = E
    order_ = _row_order(dev, args[2], rows)
    args[:3] = [a[order_].contiguous() for a in args[:3]]
    el = args[2]
    got = polish.apply_pairs(*args)
    want = polish.apply_pairs_ref(*args)
    assert got.shape == (50_001, F)
    assert (got[el < 0] == 0).all() and torch.isnan(got[el >= E]).all()
    good = (el >= 0) & (el < E)
    assert float(((got - want).abs() / want.abs().clamp_min(1e-12))[good]
                 .max()) <= 1e-12
    back = torch.argsort(order_)
    again = polish.apply_pairs(*(a[back].contiguous() for a in args[:3]),
                               *args[3:])
    assert torch.equal(_bits(again[order_]), _bits(got))


def test_apply_kernel_slot_overflow_matches_slotted(dev):
    """K5 driven through the identity permutation on random rows of 1,728
    elements (~120 distinct elements a block, past the 32 slots of order
    4, 3-D) gives bitwise the grouped launch's results, and matches the
    twin."""
    args = _apply_rows(dev, 4, 3, 20_000, 3, seed=12, shape_=(12, 12, 12))
    grouped = polish.apply_pairs(*args)
    ident = torch.arange(20_000, dtype=torch.int32, device=dev)
    plain_order = polish._apply_kernel(ident, *args)
    torch.cuda.synchronize()
    assert torch.equal(_bits(plain_order), _bits(grouped))
    want = polish.apply_pairs_ref(*args)
    assert float(((grouped - want).abs() / want.abs().clamp_min(1e-12))
                 .max()) <= 1e-12


@pytest.mark.parametrize("order,dim", ORDER_DIMS)
def test_apply_kernel_matches_twin(dev, order, dim):
    """K5 against its twin on 50,000 rows x 3 parameters: relative 1e-12;
    element -1 gives 0, an id past E gives NaN; one launch."""
    shape_ = (6, 6, 6) if dim == 3 else (20, 20)
    mesh = testing.box_mesh(shape=shape_, order=order, warp=0.15)
    rng = np.random.default_rng(order * 10 + dim)
    base = testing.smooth_field(mesh.points)
    fields = torch.as_tensor(np.stack([base, 2 * base - 1, base ** 2]),
                             device=dev)
    refs = rng.uniform(-1, 1, (50_000, dim))
    hi = torch.as_tensor(refs.astype(np.float32), device=dev)
    lo = (torch.as_tensor(refs, device=dev) - hi.double()).float()
    el = torch.as_tensor(rng.integers(0, mesh.nelem, 50_000, dtype=np.int32),
                         device=dev)
    el[::11] = -1
    before = polish.apply_pairs.launches
    got = polish.apply_pairs(hi, lo, el, fields, order, dim)
    assert polish.apply_pairs.launches == before + 1
    want = polish.apply_pairs_ref(hi, lo, el, fields, order, dim)
    assert (got[::11] == 0).all()
    assert float(((got - want).abs() / want.abs().clamp_min(1e-12)).max()) \
        <= 1e-12
    el[0] = mesh.nelem
    assert torch.isnan(polish.apply_pairs(hi, lo, el, fields, order,
                                          dim)[0]).all()


def test_scan_prefilter_on_card_matches_plain_path(dev):
    """``strategy="scan"`` with the trilinear prefilter, fixed_ref and
    AABB: the kernel path launches K1 at order 1 and agrees with the
    plain path on >= 99.9% of elements and on every accepted flag."""
    src = testing.shell_mesh(n_lat=8, n_lon=8, n_rad=8, order=4)  # E = 512
    pts = testing.shell_targets(50_000, seed=4)
    pts[:1000] *= 6.38e6 / np.linalg.norm(pts[:1000], axis=1)[:, None]
    pts = torch.as_tensor(pts, device=dev)
    kw = dict(fallback="fixed_ref", use_aabb=True, prefilter_m=4,
              strategy="scan", device=dev)
    cfg = LocateConfig(accept_tol=1.04)
    n1 = newton.newton_rows.launches_order1
    res = tloc.locate(pts, src.points, 4, cfg, **kw)
    assert newton.newton_rows.launches_order1 > n1
    plain = tloc.locate(pts, src.points, 4, cfg, plain=True, **kw)
    assert (res.elements == plain.elements).double().mean() >= 0.999
    assert (res.accepted == plain.accepted).double().mean() >= 0.9999
    assert res.found.all() and res.accepted[1000:].all()


def test_df32_transfer_on_card_matches_plain_twins(dev):
    """build with df32_polish + apply through K1, K2, K4 and K5 against
    the plain twins on the card: elements agree on >= 99.9% and values
    on agreeing rows to rtol 1e-10 (both polish to f64 refs)."""
    src = testing.shell_mesh(n_lat=8, n_lon=8, n_rad=8, order=4)  # E = 512
    pts = torch.as_tensor(testing.shell_targets(100_000, seed=6), device=dev)
    base = testing.element_nodal_field(src, "smooth")
    fields = torch.as_tensor(np.stack([base, 2 * base]), device=dev)
    cfg = LocateConfig(df32_polish=True)
    k4, k5 = polish.polish_pairs.launches, polish.apply_pairs.launches
    op = TransferOperator.build(src.points, pts, order=4, cfg=cfg,
                                fallback="snap", device=dev)
    v = op.apply(fields)
    assert polish.polish_pairs.launches > k4
    assert polish.apply_pairs.launches > k5
    p_op = TransferOperator.build(src.points, pts, order=4, cfg=cfg,
                                  fallback="snap", device=dev, plain=True)
    pv = polish.apply_pairs_ref(p_op.refs, p_op.refs_lo, p_op.elements,
                                fields, 4, 3)
    same = op.elements == p_op.elements
    assert same.double().mean() >= 0.999
    assert float(((v - pv).abs() / pv.abs())[same].max()) <= 1e-10


def _file_pair():
    """A small order-4 shell pair of the file path: the target strictly
    inside the source, its first three elements fluid."""
    src = testing.shell_mesh(n_lat=5, n_lon=5, n_rad=3, order=4)
    tgt = testing.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=4,
                             r_inner=3.6e6, r_outer=6.3e6,
                             lat_extent=(0.55, 1.15),
                             lon_extent=(0.35, 1.35))
    fluid = np.zeros(tgt.nelem)
    fluid[:3] = 1.0
    return src, tgt, fluid


_FILE_TOL = {"f32": 1e-5, "df32": 1e-10}


@pytest.mark.parametrize("polish_mode", ["f32", "df32"])
def test_file_path_on_card_matches_cpu(dev, polish_mode, tmp_path,
                                       monkeypatch):
    """``api.gll_2_gll`` file to file with ``device="cuda"`` against
    ``device="cpu"`` on the same pair: 1e-5 relative on the f32 path,
    1e-10 with ``MMT_DF32_POLISH=1``; fluid elements bit-equal."""
    pytest.importorskip("h5py", reason="the file entry points need h5py")
    import shutil

    import h5py

    from multimesh_tpu_torch import api

    if polish_mode == "df32":
        monkeypatch.setenv("MMT_DF32_POLISH", "1")
    src, tgt, fluid = _file_pair()
    testing.write_salvus_fixture(tmp_path / "src.h5", src)
    testing.write_salvus_fixture(tmp_path / "tgt0.h5", tgt, fluid=fluid,
                                 field_kind="linear")
    out = {}
    for device in ("cpu", "cuda"):
        f_tgt = shutil.copyfile(tmp_path / "tgt0.h5",
                                tmp_path / f"tgt_{device}.h5")
        values = api.gll_2_gll(tmp_path / "src.h5", f_tgt, device=device)
        with h5py.File(f_tgt, "r") as f:
            out[device] = f["MODEL/data"][()]
        assert np.array_equal(values, out[device])
    rel = np.max(np.abs(out["cuda"] - out["cpu"]) / np.abs(out["cpu"]))
    assert rel <= _FILE_TOL[polish_mode], rel
    assert np.array_equal(out["cuda"][:3], out["cpu"][:3])


@pytest.mark.parametrize("polish_mode", ["f32", "df32"])
def test_transfer_arrays_on_card_matches_cpu(dev, polish_mode, monkeypatch):
    """The file path between "arrays read" and "blocks written"
    (``engine.transfer_arrays``, a numpy sink; no ``h5py``) on the card
    against the CPU, with the tolerances of the file test; the kernels'
    launch counts move, and the pinned-buffer pull of several chunks
    gives what one chunk gives."""
    from multimesh_tpu_torch import engine

    if polish_mode == "df32":
        monkeypatch.setenv("MMT_DF32_POLISH", "1")
    src, tgt, fluid = _file_pair()
    s_nodal, _ = testing.salvus_fixture_fields(src)
    t_nodal, _ = testing.salvus_fixture_fields(tgt, fluid=fluid,
                                               field_kind="linear")
    src_data = np.stack(list(s_nodal.values()), axis=1)
    old = np.stack(list(t_nodal.values()), axis=1)
    solid = ~fluid.astype(bool)

    def run(device):
        sink = np.full(old.shape, np.nan)
        values = engine.transfer_arrays(
            src.points, src_data, list(s_nodal), tgt.points, old, solid,
            lambda names: sink, device=device)
        assert np.array_equal(values, sink)
        return sink

    before = (newton.newton_rows.launches, nearest.nearest.launches,
              polish.polish_pairs.launches, polish.apply_pairs.launches)
    got, want = run("cuda"), run("cpu")
    after = (newton.newton_rows.launches, nearest.nearest.launches,
             polish.polish_pairs.launches, polish.apply_pairs.launches)
    assert after[0] > before[0] and after[1] > before[1]
    assert (after[2] > before[2] and after[3] > before[3]) == (
        polish_mode == "df32")
    rel = np.max(np.abs(got - want) / np.abs(want))
    assert rel <= _FILE_TOL[polish_mode], rel
    assert np.array_equal(got[:3], old[:3])

    # several chunks through the side-stream pull against one chunk
    vals = torch.as_tensor(
        np.random.default_rng(0).uniform(1.0, 2.0, (1000, 4)), device=dev)
    host, wait = engine._start_pull(list(vals.split(300)), 300)
    wait(3)
    assert np.array_equal(host, vals.cpu().numpy())


@pytest.mark.parametrize("M", [262_144, 8_192])
def test_group_rows_at_half_a_million_elements(dev, M):
    """The counting sort over 500,001 bins (its scan walks them all,
    whatever M): a locate chunk's and a rescue round's rows, a tenth of
    the ids out of range."""
    E = 500_000
    rng = np.random.default_rng(M)
    ids = rng.integers(0, E, M).astype(np.int32)
    ids[rng.random(M) < 0.05] = -1
    ids[rng.random(M) < 0.05] = E + 3
    ids_d = torch.as_tensor(ids, device=dev)
    perm = newton.group_rows(ids_d, E)
    assert torch.equal(torch.sort(perm.long()).values,
                       torch.arange(M, device=dev))
    want = newton.group_rows_ref(ids_d, E)
    key = torch.where((ids_d >= 0) & (ids_d < E), ids_d, E)
    assert torch.equal(key[perm.long()], key[want.long()])


def test_newton_kernel_all_distinct_ids_bitwise_row_order(dev):
    """Sparse rows, as a 500,000-element source gives them: every row its
    own element, so no block shares a lattice and nearly every row reads
    global memory.  Grouped and in row order (the identity permutation)
    the results are the same bits, and they match the twin."""
    mesh = testing.box_mesh(shape=(24, 24, 24), order=4, warp=0.1)
    E = mesh.nelem  # 13,824
    prep = tloc._mesh_prep(mesh.points, 4, dev)
    order_ = torch.randperm(E, device=dev)
    ids = order_.to(torch.int32).contiguous()
    pts = prep.centroids[order_].contiguous()
    args = (pts, ids, prep.ctr, prep.inv_scale, prep.nodes, 4, 3, 18, 8.0)
    g_ref, g_res = newton.newton_rows(*args)
    ident = torch.arange(E, dtype=torch.int32, device=dev)
    i_ref, i_res = newton._newton_kernel(ident, *args)
    assert torch.equal(g_ref, i_ref) and torch.equal(g_res, i_res)
    p_ref, p_res = newton.newton_refs_rows_ref(*args)
    ka = (g_res < 1e-4) & (g_ref.abs().amax(-1) < 1.05)
    pa = (p_res < 1e-4) & (p_ref.abs().amax(-1) < 1.05)
    assert torch.equal(ka, pa) and bool(ka.all())
    assert float((g_ref - p_ref).abs().max()) <= 1e-5


def test_polish_kernel_all_distinct_ids_bitwise_row_order(dev):
    """K4 on sparse rows (13,824 rows, every one its own element: each
    block has far more runs than slots, so nearly every row reads the f64
    lattice from global memory): grouped and in row order the same bits,
    ok everywhere, hi + lo to 1e-12 of the twin's and within 1e-10 of the
    known refs."""
    M = 24 ** 3
    args, refs = _polish_rows(dev, 4, 3, M, seed=21, shape_=(24, 24, 24),
                              distinct=True)
    assert torch.unique(args[1]).numel() == M
    grouped = polish.polish_pairs(*args, 1)
    ident = torch.arange(M, dtype=torch.int32, device=dev)
    row_order = polish._polish_kernel(ident, *args, 1)
    torch.cuda.synchronize()
    for x, y in zip(row_order, grouped):
        assert torch.equal(_bits(x), _bits(y))
    p_hi, p_lo, p_ok = polish.polish_pairs_ref(*args, 1)
    assert torch.equal(grouped[2], p_ok) and bool(p_ok.all())
    got = grouped[0].double() + grouped[1].double()
    assert float((got - (p_hi.double() + p_lo.double())).abs().max()) <= 1e-12
    assert float((got - refs).abs().max()) < 1e-10


def test_apply_kernel_all_distinct_ids_bitwise_row_order(dev):
    """K5 on sparse rows (13,824 rows, every one its own element, 3
    parameters, a few ids -1): grouped and in row order the same bits,
    every column within 1e-12 relative of the twin, 0 where the id is
    -1."""
    M = 24 ** 3
    args = _apply_rows(dev, 4, 3, M, 3, seed=22, shape_=(24, 24, 24),
                       distinct=True)
    args[2][::97] = -1
    el = args[2]
    assert torch.unique(el[el >= 0]).numel() == int((el >= 0).sum())
    grouped = polish.apply_pairs(*args)
    ident = torch.arange(M, dtype=torch.int32, device=dev)
    row_order = polish._apply_kernel(ident, *args)
    torch.cuda.synchronize()
    assert torch.equal(_bits(row_order), _bits(grouped))
    want = polish.apply_pairs_ref(*args)
    assert (grouped[el < 0] == 0).all()
    rel = (grouped - want).abs() / want.abs().clamp_min(1e-12)
    assert float(rel[el >= 0].max()) <= 1e-12


@pytest.mark.parametrize("polish_mode", ["f32", "df32"])
def test_grid_route_on_card_matches_cpu(dev, polish_mode, monkeypatch):
    """The grid route (threshold lowered to 64, 32-member round-1 bins, a
    4,096-element order-2 shell: 128 bins, partial probes) on the card
    against the same call on the CPU: found equal, elements on >= 99.9%
    of the rows both accept and on >= 99% of all (a snapped exterior row
    may pick another, equally good boundary element), accepted refs to 1e-5 where elements agree; K1
    (and K4 with the polish) launched, K2 not."""
    monkeypatch.setattr(tgrid, "APPROX_GRID_MIN_SOURCES", 64)
    monkeypatch.setattr(tloc, "ROUND1_MEMBERS", 32)
    src = testing.shell_mesh(n_lat=16, n_lon=16, n_rad=16, order=2)
    pts = testing.shell_targets(60_000, seed=12)
    pts[:6_000] *= 1.5
    cfg = LocateConfig(df32_polish=polish_mode == "df32")
    n0, k0 = newton.newton_rows.launches, nearest.nearest.launches
    p0 = polish.polish_pairs.launches
    got = tloc.locate(pts, src.points, 2, cfg, fallback="snap", device=dev,
                      chunk=16_384)
    assert newton.newton_rows.launches > n0
    assert nearest.nearest.launches == k0
    assert (polish.polish_pairs.launches > p0) == (polish_mode == "df32")
    want = tloc.locate(pts, src.points, 2, cfg, fallback="snap",
                       device="cpu", chunk=16_384)
    assert torch.equal(got.found.cpu(), want.found)
    assert (got.accepted.cpu() == want.accepted).double().mean() >= 0.9999
    same = got.elements.cpu() == want.elements
    both = want.accepted & got.accepted.cpu()
    assert same.double().mean() >= 0.99
    assert same[both].double().mean() >= 0.999
    keep = same & both
    assert float((got.refs.cpu() - want.refs)[keep].abs().max()) <= 1e-5
    if polish_mode == "df32":
        pair = got.refs.double() + got.refs_lo.double()
        w_pair = want.refs.double() + want.refs_lo.double()
        assert float((pair.cpu() - w_pair)[keep].abs().max()) <= 1e-10


@pytest.mark.parametrize("order,shape_", [(1, (64, 64)), (4, (24, 24))])
def test_newton_and_polish_kernels_2d_at_the_main_path_shapes(dev, order,
                                                              shape_):
    """K1 and K4 at 1/2 and 4/2 on 262,144 rows of the 2-D shapes the
    pipelines run (a QUAD4 Exodus source, the ``grid2d`` box): K1's
    acceptance agrees with its twin on >= 99.99% of rows and accepted
    refs to 1e-5; K4 from those refs agrees on ok and to 1e-11."""
    M = 262_144
    args = _newton_args(dev, order, 2, M, seed=70 + order, shape_=shape_)
    k_ref, k_res = newton.newton_rows(*args)
    p_ref, p_res = newton.newton_refs_rows_ref(*args)
    ka = (k_res < 1e-4) & (k_ref.abs().amax(-1) < 1.05)
    pa = (p_res < 1e-4) & (p_ref.abs().amax(-1) < 1.05)
    assert (ka == pa).double().mean() >= 0.9999
    both = ka & pa
    assert both.double().mean() > 0.8
    assert float((k_ref - p_ref)[both].abs().max()) <= 1e-5
    mesh = testing.box_mesh(shape=shape_, order=order, warp=0.15)
    prep = tloc._mesh_prep(mesh.points, order, dev, want64=True)
    rows = torch.nonzero(both).squeeze(1)
    pargs = (args[0][rows].contiguous(), args[1][rows].contiguous(),
             k_ref[rows].contiguous(), prep.ctr, prep.inv_scale,
             prep.nodes64, order, 2, 1)
    hi, lo, ok = polish.polish_pairs(*pargs)
    t_hi, t_lo, t_ok = polish.polish_pairs_ref(*pargs)
    assert (ok == t_ok).double().mean() >= 0.9999
    keep = ok & t_ok
    assert float(((hi.double() + lo.double())
                  - (t_hi.double() + t_lo.double()))[keep].abs().max()
                 ) <= 1e-11


def test_newton_kernel_order1_sparse_ids_over_an_exodus_source(dev):
    """K1 at 1/3 on the corner lattice of a 40 x 40 x 36 = 57,600-hex
    shell, 262,144 rows whose ids are the nearest member of the grid
    index (nearly every row of a block its own element): acceptance at
    the Exodus paths' 1.025 agrees with the twin on >= 99.99% of rows,
    accepted refs to 1e-5."""
    src = testing.shell_mesh(n_lat=40, n_lon=40, n_rad=36, order=1)
    assert src.nelem == 57_600 > tgrid.APPROX_GRID_MIN_SOURCES
    prep = tloc._mesh_prep(src.points, 1, dev)
    index = tgrid.get_grid_index(prep.centroids_host, tloc.ROUND1_MEMBERS,
                                 dev)
    pts = torch.as_tensor(testing.shell_targets(262_144, seed=5),
                          device=dev)
    ids = tgrid.nearest_member(index, pts, n_probe=tloc.ROUND1_PROBES)
    assert int(torch.unique(ids).numel()) > 40_000
    args = (pts, ids.contiguous(), prep.ctr, prep.inv_scale, prep.nodes, 1,
            3, 18, 8.0)
    before = newton.newton_rows.launches
    k_ref, k_res = newton.newton_rows(*args)
    assert newton.newton_rows.launches == before + 1
    p_ref, p_res = newton.newton_refs_rows_ref(*args)
    ka = (k_res < 1e-4) & (k_ref.abs().amax(-1) < 1.025)
    pa = (p_res < 1e-4) & (p_ref.abs().amax(-1) < 1.025)
    assert (ka == pa).double().mean() >= 0.9999
    assert (ka & pa).double().mean() > 0.9
    assert float((k_ref - p_ref)[ka & pa].abs().max()) <= 1e-5


def test_chunk_round1_accepts_whole_skips_the_rescue_rounds(dev,
                                                            monkeypatch):
    """262,144 targets inside the 4,096-element shell, one chunk that
    round 1 accepts whole: K1 launches once and neither the top-8 rescue
    (``centred_topk``) nor round 4's ``knn`` runs.  The result is bit for
    bit what the fixed buckets (``_rescue_rows`` patched back to its cap)
    give on the card, and the allocator's peak rises less during the
    call."""
    src = testing.shell_mesh(n_lat=16, n_lon=16, n_rad=16, order=4)
    assert src.nelem == 4_096
    pts = torch.as_tensor(testing.shell_targets(262_144, seed=9), device=dev)
    calls = []

    def watch(name):
        fn = getattr(tknn, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)

        monkeypatch.setattr(tknn, name, wrapped)

    watch("centred_topk")
    watch("knn")

    def run():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n0 = newton.newton_rows.launches
        calls.clear()
        res = tloc.locate(pts, src.points, 4, fallback="snap", device=dev)
        torch.cuda.synchronize()
        return (res, newton.newton_rows.launches - n0, list(calls),
                torch.cuda.max_memory_allocated() - base)

    run()  # the lattice prepared and cached, the kernels loaded
    got, launches, got_calls, rise = run()
    with monkeypatch.context() as m:
        m.setattr(tloc, "_rescue_rows", lambda B, n_unaccepted: B)
        want, fixed_launches, fixed_calls, fixed_rise = run()
    assert bool(got.accepted.all()) and got.n_retry == 0
    assert launches == 1 and got_calls == []
    assert fixed_launches == 4
    assert fixed_calls == ["centred_topk", "knn"]
    for f in ("elements", "refs", "weights", "found", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert rise < fixed_rise, (rise, fixed_rise)


@pytest.mark.parametrize("strategy", ["ladder", "scan"])
def test_locate_given_candidates_on_card_matches_plain_path(dev, strategy):
    """``locate(candidates=)`` through the kernels against ``plain=True``
    on the card: found equal, elements on >= 99.9% of the accepted rows,
    refs there to 1e-5; K1 launched, K2 not (no internal search)."""
    src = testing.shell_mesh(n_lat=8, n_lon=8, n_rad=8, order=2)
    pts = testing.shell_targets(40_000, seed=3)
    pts[:4_000] *= 2.0
    cent = torch.as_tensor(src.points.mean(axis=1), device=dev)
    d2 = torch.cdist(torch.as_tensor(pts, device=dev), cent)
    cand = d2.topk(6, dim=1, largest=False).indices.to(torch.int32)
    n0, k0 = newton.newton_rows.launches, nearest.nearest.launches
    kw = dict(fallback="sentinel", strategy=strategy, candidates=cand,
              device=dev)
    got = tloc.locate(pts, src.points, 2, **kw)
    assert newton.newton_rows.launches > n0
    assert nearest.nearest.launches == k0
    want = tloc.locate(pts, src.points, 2, plain=True, **kw)
    assert torch.equal(got.found, want.found)
    assert got.found[4_000:].all() and not got.found[:4_000].any()
    same = (got.elements == want.elements) & got.found
    assert same.sum() >= 0.999 * got.found.sum()
    assert float((got.refs - want.refs)[same].abs().max()) <= 1e-5


def test_exodus_2_exodus_on_card_matches_cpu(dev, tmp_path):
    """The Exodus file path (scipy only) on the card against the same call
    on the CPU: every written value to rtol 1e-5 (an order-1 target on a
    face is accepted by two hexes, so values, not ids)."""
    import shutil

    from multimesh_tpu_torch import engine
    from multimesh_tpu_torch.io import exodus as eio

    src = testing.shell_mesh(n_lat=10, n_lon=10, n_rad=8, order=1)
    tgt = testing.shell_mesh(n_lat=7, n_lon=7, n_rad=6, order=1,
                             r_inner=3.7e6, r_outer=6.2e6,
                             lat_extent=(0.55, 1.15),
                             lon_extent=(0.35, 1.35))
    testing.write_exodus_fixture(tmp_path / "a.e", src, ("VP", "VS"))
    testing.write_exodus_fixture(tmp_path / "b.e", tgt, ("VP", "VS"),
                                 field_kind="linear")
    shutil.copyfile(tmp_path / "b.e", tmp_path / "b_cpu.e")
    n0 = newton.newton_rows.launches
    engine.exodus_2_exodus(tmp_path / "a.e", tmp_path / "b.e",
                           parameters=["VP", "VS"], device=dev)
    assert newton.newton_rows.launches > n0
    engine.exodus_2_exodus(tmp_path / "a.e", tmp_path / "b_cpu.e",
                           parameters=["VP", "VS"], device="cpu")
    for p in ("VP", "VS"):
        np.testing.assert_allclose(
            eio.Exodus(tmp_path / "b.e").get_nodal_field(p),
            eio.Exodus(tmp_path / "b_cpu.e").get_nodal_field(p), rtol=1e-5)


def test_sharded_schemes_at_world_size_1_on_card(dev):
    """Both sharded schemes on a one-rank nccl group (``make_mesh(1)``)
    against ``TransferOperator`` on the card, bit for bit: the replicated
    scheme runs the operator's program on every row, and the
    source-sharded one's only rank holds every element in global order
    (its pass 2 retries the misses against the same elements).  K1 and
    K2 were launched; the group is destroyed after."""
    import torch.distributed as dist

    from multimesh_tpu_torch.dist import (make_mesh, sharded_transfer,
                                          source_sharded_transfer)

    src = testing.shell_mesh(n_lat=8, n_lon=8, n_rad=8, order=4)  # E = 512
    pts = testing.shell_targets(50_000, seed=4)
    base = testing.element_nodal_field(src, "smooth")
    fields = np.stack([base, 2 * base])
    mesh = make_mesh(1, device=dev)
    try:
        assert dist.get_backend(mesh.get_group()) == "nccl"
        n0, k0 = newton.newton_rows.launches, nearest.nearest.launches
        got = sharded_transfer(torch.as_tensor(pts, device=dev), src.points,
                               fields, order=4, fallback="snap", mesh=mesh,
                               device_out=True, device=dev)
        assert newton.newton_rows.launches > n0
        assert nearest.nearest.launches > k0
        want = TransferOperator.build(src.points, pts, order=4,
                                      fallback="snap", device=dev).apply(
            torch.as_tensor(fields, device=dev))
        assert got.device.type == "cuda" and torch.equal(got, want)
        for fallback in ("sentinel", "snap"):
            want = TransferOperator.build(
                src.points, pts, order=4, fallback=fallback,
                device=dev).apply(torch.as_tensor(fields, device=dev))
            got = source_sharded_transfer(pts, src.points, fields, order=4,
                                          fallback=fallback, mesh=mesh,
                                          device=dev)
            np.testing.assert_array_equal(got,
                                          want.double().cpu().numpy())
    finally:
        dist.destroy_process_group()


# -- the dedup on the card (ops/dedup.py unique_points_device) -------------
# the targets of the benchmark's mesh jobs: order-4 shells, as
# ((n_lat, n_lon, n_rad), slots, unique points)
MESH_NEW = {"mesh_new_1m": ((20, 20, 20), 1_000_000, 531_441),
            "mesh_new_10m": ((37, 37, 58), 9_925_250, 5_172_833)}


def mesh_new_target(case, angle=0.03):
    """The target of the benchmark's ``case`` jobs, rotated about the
    polar axis, [E, 125, 3]."""
    n_lat, n_lon, n_rad = MESH_NEW[case][0]
    tgt = testing.shell_mesh(n_lat=n_lat, n_lon=n_lon, n_rad=n_rad, order=4,
                             r_inner=3.7e6, r_outer=6.2e6,
                             lat_extent=(0.58, 1.12),
                             lon_extent=(0.38, 1.32))
    c, s_ = np.cos(angle), np.sin(angle)
    x, y, z = np.moveaxis(tgt.points, -1, 0)
    return np.stack([c * x - s_ * y, s_ * x + c * y, z], axis=-1)


def _dedup_input(case):
    if case == "shuffled":
        flat = testing.shell_mesh(n_lat=6, n_lon=6, n_rad=6,
                                  order=4).points.reshape(-1, 3)
        return flat[np.random.default_rng(5).permutation(len(flat))]
    if case in MESH_NEW:
        return mesh_new_target(case).reshape(-1, 3)
    return testing.dedup_edge_points(case)


def _card_dedup(pts, dev):
    """``unique_points_device`` on the card with its cache emptied, under
    ``MMT_PROFILE``: (unique rows, recon, its dedup counters)."""
    tdedup._UNIQ_DEV_CACHE.clear()
    utils_profile.reset_stages()
    uniq, recon = tdedup.unique_points_device(pts, 1, device=dev)
    counters = {k: v for k, v in utils_profile.counter_totals().items()
                if k.startswith("dedup.")}
    utils_profile.reset_stages()
    return uniq, recon, counters


@pytest.mark.parametrize("case", list(testing.DEDUP_EDGE_CASES)
                         + ["shuffled", *MESH_NEW])
def test_dedup_kernel_matches_host_path_bitwise(dev, case, monkeypatch):
    """The card's dedup (``unique_points_device``'s CUDA branch:
    ``dedup_first`` on the rows uploaded as f64) against the host path's
    ``unique_points(order_by="first")``: unique rows and recon bit for
    bit, on three runs of the same input; each run counts its rows as
    grouped on the card and none on the host."""
    monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
    pts = _dedup_input(case)
    want_u, want_r = tdedup.unique_points(pts, order_by="first")
    if case in MESH_NEW:
        _, n_slots, n_unique = MESH_NEW[case]
        assert pts.shape == (n_slots, 3) and len(want_u) == n_unique
    monkeypatch.setenv("MMT_PROFILE", "1")
    for _ in range(3):
        uniq, recon, counters = _card_dedup(pts, dev)
        assert counters == {"dedup.card_rows": len(pts),
                            "dedup.unique_rows": len(want_u)}
        assert uniq.device.type == "cuda" and recon.dtype == np.int64
        got_u = uniq.cpu().numpy()
        assert got_u.shape == want_u.shape
        np.testing.assert_array_equal(got_u.view(np.int64),
                                      want_u.view(np.int64))
        np.testing.assert_array_equal(recon, want_r)


def test_device_dedup_takes_f32_coordinates(dev, monkeypatch):
    """``unique_points_device`` on the card groups f32 coordinates as the
    host path groups them: the rows are uploaded as f64 (exact), so the
    unique rows are the host path's widened and recon is the same."""
    monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
    pts = testing.shell_mesh(n_lat=4, n_lon=4, n_rad=4,
                             order=4).points.astype(np.float32)
    want_u, want_r = tdedup.unique_points(pts, order_by="first")
    monkeypatch.setenv("MMT_PROFILE", "1")
    uniq, recon, counters = _card_dedup(pts, dev)
    assert counters["dedup.card_rows"] == pts.shape[0] * pts.shape[1]
    assert uniq.dtype == torch.float64
    np.testing.assert_array_equal(uniq.cpu().numpy(),
                                  want_u.astype(np.float64))
    np.testing.assert_array_equal(recon, want_r)


def test_transfer_arrays_card_dedup_matches_host_dedup(dev, tmp_path,
                                                       monkeypatch):
    """``engine.transfer_arrays`` on the card with the card's dedup and
    with the host path's (the unique points uploaded): the same sink
    values, bit for bit, and the same ``recon.npy`` under
    ``stored_array``, byte for byte."""
    from multimesh_tpu_torch import engine

    src, tgt, fluid = _file_pair()
    s_nodal, _ = testing.salvus_fixture_fields(src)
    t_nodal, _ = testing.salvus_fixture_fields(tgt, fluid=fluid,
                                               field_kind="linear")
    src_data = np.stack(list(s_nodal.values()), axis=1)
    old = np.stack(list(t_nodal.values()), axis=1)

    def run(stored):
        monkeypatch.setattr(tdedup, "_UNIQ_CACHE", {})
        monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
        sink = np.full(old.shape, np.nan)
        engine.transfer_arrays(
            src.points, src_data, list(s_nodal), tgt.points, old,
            ~fluid.astype(bool), lambda names: sink, stored_array=stored,
            device=dev)
        return sink

    def host_dedup(points, fingerprint, order_by="first", device="cuda",
                   uploaded=None):
        uniq, recon = tdedup.unique_points(points, order_by=order_by)
        return torch.as_tensor(uniq, device=device), recon

    monkeypatch.setenv("MMT_PROFILE", "1")
    utils_profile.reset_stages()
    card = run(tmp_path / "card")
    n_slots = tgt.points.shape[0] * tgt.points.shape[1]
    assert utils_profile.counter_totals()["dedup.card_rows"] == n_slots
    monkeypatch.setattr(engine, "unique_points_device", host_dedup)
    utils_profile.reset_stages()
    host = run(tmp_path / "host")
    assert "dedup.card_rows" not in utils_profile.counter_totals()
    utils_profile.reset_stages()
    np.testing.assert_array_equal(card.view(np.int64), host.view(np.int64))
    assert ((tmp_path / "card" / "recon.npy").read_bytes()
            == (tmp_path / "host" / "recon.npy").read_bytes())


# -- the mesh path's expansion on the card (engine._stream_expand_write) ---
def test_transfer_arrays_expands_on_the_card_as_the_host(dev, tmp_path,
                                                         monkeypatch):
    """``engine.transfer_arrays`` on the card onto the 1M-slot target of
    ``mesh_new_1m``, 4 elements fluid and one source element's VS zero:
    the sink and the returned values bit-equal to a host expansion
    (``vals[recon]``, relayout, f64, ``repair_fluid_solid``) of the same
    operator's unique values, and again through a stored copy of that
    operator whose rows and recon are reversed.  Every slot counts as
    expanded on the card, the reverted elements as patched; ``values``
    owns its memory, and the warm calls pin no new host memory."""
    from multimesh_tpu_torch import engine
    from multimesh_tpu_torch.ops.fluid import repair_fluid_solid

    src = testing.shell_mesh(n_lat=16, n_lon=16, n_rad=16, order=4)
    tgt = mesh_new_target("mesh_new_1m")
    E, n = tgt.shape[:2]
    params = ["VP", "VS", "RHO"]
    base = testing.element_nodal_field(src)
    src_data = np.stack([base, 1.1 * base, 1.2 * base], axis=1)
    centre = tgt[4000].mean(axis=0)
    src_data[np.argmin(((src.points.mean(axis=1) - centre) ** 2).sum(1)),
             1] = 0.0
    fields = np.ascontiguousarray(np.moveaxis(src_data, 1, 0))
    old = np.random.default_rng(0).uniform(6.0, 9.0, (E, 3, n))
    solid = np.ones(E, bool)
    solid[[0, 1, 2, 4321]] = False
    monkeypatch.setenv("MMT_PROFILE", "1")

    def run(stored):
        sink = np.full(old.shape, np.nan)
        utils_profile.reset_stages()
        values = engine.transfer_arrays(
            src.points, src_data, params, tgt, old, solid,
            lambda names: sink, stored_array=stored, device=dev)
        counters = utils_profile.counter_totals()
        utils_profile.reset_stages()
        assert values.flags.owndata
        return values, sink, counters

    def host_expansion(stored):
        op = TransferOperator.load(stored, device=dev)
        vals = op.apply(fields, expand=False).cpu().numpy()
        full = vals[op.recon.cpu().numpy()].reshape(E, n, 3).transpose(
            0, 2, 1).astype(np.float64)
        reverted = int(((full[:, 1] == 0).any(axis=1) & solid).sum())
        return repair_fluid_solid(full, old, solid, params), reverted

    a, b = tmp_path / "a", tmp_path / "b"
    values, sink, counters = run(a)
    want, reverted = host_expansion(a)
    assert reverted > 0
    np.testing.assert_array_equal(values.view(np.int64), want.view(np.int64))
    np.testing.assert_array_equal(sink.view(np.int64), want.view(np.int64))
    assert counters["expand.card_slots"] == E * n
    assert counters["expand.patched_elems"] == 4 + reverted
    pinned = torch.cuda.host_memory_stats()["num_host_alloc"]

    testing.reverse_stored_operator(a, b)
    values_b, sink_b, counters_b = run(b)
    want_b, _ = host_expansion(b)
    assert not np.array_equal(np.load(a / "recon.npy"),
                              np.load(b / "recon.npy"))
    np.testing.assert_array_equal(values_b.view(np.int64),
                                  want_b.view(np.int64))
    np.testing.assert_array_equal(sink_b.view(np.int64),
                                  want_b.view(np.int64))
    np.testing.assert_array_equal(values_b.view(np.int64),
                                  values.view(np.int64))
    assert counters_b["expand.patched_elems"] == 4 + reverted
    run(a)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == pinned


# -- the layered path's dedup on the card (ops/dedup.dedup_sorted) ---------
def _layered_pair():
    """A small 4-layer order-4 shell pair: the target inside the source,
    their layer interfaces on the same radii."""
    src = testing.shell_mesh(n_lat=5, n_lon=5, n_rad=8, order=4, n_layers=4)
    tgt = testing.shell_mesh(n_lat=4, n_lon=4, n_rad=8, order=4, n_layers=4,
                             lat_extent=(0.55, 1.15),
                             lon_extent=(0.35, 1.35))
    return src, tgt


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_layered_dedup_on_card_matches_host_bitwise(dev, dtype,
                                                    monkeypatch):
    """``unique_points_per_layer`` on the card (``dedup_sorted`` on each
    layer's rows) against the host lexsort on the same layer: unique rows
    (tensors on the card in the input's dtype) and recon (int64 on the
    card) bit for bit, every row counted as grouped on the card."""
    from multimesh_tpu_torch.ops import layers as tlayers

    _, tgt = _layered_pair()
    pts = tgt.points.astype(dtype)
    masks = tlayers.layer_masks(tgt.layer_id, [4, 3, 2, 1])
    monkeypatch.setenv("MMT_PROFILE", "1")
    utils_profile.reset_stages()
    got = tdedup.unique_points_per_layer(pts, masks, device=dev)
    counters = {k: v for k, v in utils_profile.counter_totals().items()
                if k.startswith("dedup.")}
    utils_profile.reset_stages()
    assert list(got) == list(masks)
    n_unique = 0
    for layer, mask in masks.items():
        want_u, want_r = tdedup.unique_points(pts[mask])
        uniq, recon = got[layer]
        assert uniq.device.type == recon.device.type == "cuda"
        assert recon.dtype == torch.int64
        got_u = uniq.cpu().numpy()
        assert got_u.dtype == want_u.dtype and got_u.shape == want_u.shape
        bits = f"i{got_u.itemsize}"
        np.testing.assert_array_equal(got_u.view(bits), want_u.view(bits))
        np.testing.assert_array_equal(recon.cpu().numpy(), want_r)
        n_unique += len(want_u)
    assert counters == {"dedup.card_rows": pts.shape[0] * pts.shape[1],
                        "dedup.unique_rows": n_unique}


def _live_layered(mesh, field_kind):
    """A live mesh object, as a salvus user holds it, for the layered
    entries."""
    nodal, elemental = testing.salvus_fixture_fields(
        mesh, ("VP", "VS"), field_kind=field_kind)
    return types.SimpleNamespace(points=mesh.points,
                                 element_nodal_fields=dict(nodal),
                                 elemental_fields=elemental)


def _layered_run(device, stored=None):
    """``engine.gll_2_gll_layered`` of ``_layered_pair`` onto a fresh
    target on ``device``: the written (VP, VS)."""
    from multimesh_tpu_torch import engine

    src, tgt = _layered_pair()
    new = _live_layered(tgt, "linear")
    engine.gll_2_gll_layered(_live_layered(src, "smooth"), new,
                             layers="all", parameters=["VP", "VS"],
                             stored_array=stored, device=device)
    return np.stack([new.element_nodal_fields[p] for p in ("VP", "VS")])


def test_layered_on_card_matches_cpu(dev, monkeypatch):
    """``engine.gll_2_gll_layered`` on the card, which groups each
    layer's slots there, against ``device="cpu"``, which runs the host
    lexsort: within the file path's f32 tolerance."""
    monkeypatch.setenv("MMT_PROFILE", "1")
    utils_profile.reset_stages()
    got = _layered_run(dev)
    counters = utils_profile.counter_totals()
    utils_profile.reset_stages()
    _, tgt = _layered_pair()
    assert counters["dedup.card_rows"] == tgt.nelem * tgt.n_gll
    assert "dedup.host_rows" not in counters
    want = _layered_run("cpu")
    rel = np.max(np.abs(got - want) / np.abs(want))
    assert rel <= _FILE_TOL["f32"], rel


class _MemH5:
    """A stand-in for ``h5py`` (the card's machine has none) that keeps
    each file's datasets and attributes in memory and leaves an empty
    file on disk: all that ``interp_info.h5`` needs of it."""

    class _File(dict):
        def __init__(self):
            super().__init__()
            self.attrs = {}

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def create_dataset(self, name, data):
            self[name] = np.array(data)

    def __init__(self):
        self.files = {}

    def File(self, path, mode="r"):
        if mode == "w":
            open(path, "wb").close()
            self.files[str(path)] = self._File()
        return self.files[str(path)]


def test_layered_cache_from_the_host_is_served_on_card(dev, tmp_path,
                                                       monkeypatch):
    """An ``interp_info.h5`` written by the host path (its coefficients
    in the host lexsort's unique-row order) is served to the card path,
    whose recon comes from the card's grouping: with the stored
    coefficients doubled, the card writes twice the host's values."""
    h5 = _MemH5()
    monkeypatch.setitem(sys.modules, "h5py", h5)
    want = _layered_run("cpu", stored=tmp_path)
    (store,) = h5.files.values()
    layers = [k.split("/")[1] for k in store if k.startswith("coeffs/")]
    assert sorted(layers) == ["1", "2", "3", "4"]
    for layer in layers:
        store[f"coeffs/{layer}"] = 2.0 * store[f"coeffs/{layer}"]
    monkeypatch.setenv("MMT_PROFILE", "1")
    utils_profile.reset_stages()
    got = _layered_run(dev, stored=tmp_path)
    counters = utils_profile.counter_totals()
    stages = utils_profile.stage_totals()
    utils_profile.reset_stages()
    assert counters["dedup.card_rows"] > 0
    assert "layered.build" not in stages  # served, not rebuilt
    np.testing.assert_allclose(got, 2.0 * want, rtol=_FILE_TOL["f32"])


# -- the content fingerprint's weighted-sum layer on the card --------------
def _hash_input(case):
    """Arrays the card's fingerprint takes: the two mesh targets of the
    benchmark (f64 [E, 125, 3]), odd sizes of words and tails, f32."""
    rng = np.random.default_rng(11)
    C = hashing.HASH_COLS
    if case in MESH_NEW:
        return mesh_new_target(case)
    return {
        "under_a_row": lambda: rng.integers(0, 256, 4 * C - 5, np.uint8),
        "one_row": lambda: rng.integers(0, 256, 4 * C, np.uint8),
        "r257_leftover_and_tail": lambda: rng.integers(
            0, 256, 4 * (257 * C + 3) + 1, np.uint8),
        "r513_f32": lambda: rng.normal(size=513 * C + 5).astype(np.float32),
    }[case]()


@pytest.mark.parametrize("case", ["under_a_row", "one_row",
                                  "r257_leftover_and_tail", "r513_f32",
                                  *MESH_NEW])
def test_content_sums_kernel_matches_twin_and_host(dev, case, monkeypatch):
    """``content_fingerprint_device`` on the card returns
    ``content_fingerprint``'s value and the array's upload, bit for bit;
    its kernel's four sums equal the plain twin's and the host's numpy
    layer 1 on every row, twice (the atomics' order moves, the sums do
    not); under a row nothing launches and the host sums the words."""
    a = _hash_input(case)
    C = hashing.HASH_COLS
    R = a.nbytes // 4 // C
    monkeypatch.setenv("MMT_PROFILE", "1")
    utils_profile.reset_stages()
    before = hashing.layer1_sums.launches
    fp, up = hashing.content_fingerprint_device(a, dev)
    counters = utils_profile.counter_totals()
    utils_profile.reset_stages()
    assert fp == hashing.content_fingerprint(a)
    assert up.device.type == "cuda" and up.shape == a.shape
    np.testing.assert_array_equal(up.cpu().numpy().view(np.uint8),
                                  a.view(np.uint8))
    assert hashing.layer1_sums.launches == before + (R > 0)
    if R == 0:
        assert counters == {"fingerprint.host_bytes": a.nbytes // 4 * 4}
        return
    assert counters == {"fingerprint.card_bytes": 4 * R * C}
    words = up.reshape(-1).view(torch.uint8)[: 4 * R * C].view(
        torch.int32).view(R, C)
    got = [hashing.layer1_sums(words).cpu().numpy().view(np.uint32)
           for _ in range(2)]
    twin = hashing.layer1_sums_ref(words).cpu().numpy().view(np.uint32)
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_array_equal(got[0], twin)
    head = a.reshape(-1).view(np.uint8)[: 4 * R * C].view(np.uint32)
    col, row, colw, roww = hashing.layer1_sums_host(head.reshape(R, C))
    np.testing.assert_array_equal(
        got[0], np.concatenate([col, colw, row, roww]))


@pytest.mark.parametrize("n_bytes,dtype", [
    (0, np.float64), (3, np.uint8), (8, np.float64),
    (2 * hashing._UPLOAD_CHUNK, np.uint8),
    (3 * hashing._UPLOAD_CHUNK + 40, np.float32)])
def test_upload_through_pinned_chunks_is_the_array(dev, n_bytes, dtype):
    """``hashing._upload`` gives an array's bytes on the card, whole
    chunks, a ragged last chunk and none at all; the host array may
    change once it has returned."""
    a = np.random.default_rng(n_bytes).integers(
        0, 256, n_bytes, np.uint8).view(dtype).reshape(-1, 1)
    want = a.copy()
    up = hashing._upload(a.reshape(-1).view(np.uint8), dev)
    a[...] = 0
    assert up.device.type == "cuda" and up.dtype == torch.uint8
    np.testing.assert_array_equal(up.cpu().numpy(),
                                  want.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dedup_takes_the_fingerprints_upload(dev, dtype, monkeypatch):
    """``unique_points_device`` fed the tensor ``content_fingerprint_device``
    uploaded (f32 widened on the card) gives the unique rows and recon
    of the host path, bit for bit, and of its own upload."""
    pts = mesh_new_target("mesh_new_1m").astype(dtype)
    want_u, want_r = tdedup.unique_points(pts, order_by="first")
    fp, up = hashing.content_fingerprint_device(pts, dev)
    runs = []
    for uploaded in (up, None):
        monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
        uniq, recon = tdedup.unique_points_device(pts, fp, device=dev,
                                                  uploaded=uploaded)
        assert uniq.dtype == torch.float64
        runs.append((uniq.cpu().numpy(), recon))
    for got_u, got_r in runs:
        np.testing.assert_array_equal(got_u.view(np.int64),
                                      want_u.astype(np.float64).view(np.int64))
        np.testing.assert_array_equal(got_r, want_r)


def test_stored_operator_passes_between_host_and_card_fingerprints(
        dev, tmp_path, monkeypatch, capsys):
    """An operator that ``transfer_arrays`` saved on the CPU (the host's
    fingerprint) loads on the card (the card's) without a dedup, and one
    saved on the card loads on the CPU; a writable source is hashed on
    the card as well, and no call takes it from the identity cache."""
    from multimesh_tpu_torch import engine

    src, tgt, fluid = _file_pair()
    s_nodal, _ = testing.salvus_fixture_fields(src)
    t_nodal, _ = testing.salvus_fixture_fields(tgt, fluid=fluid,
                                               field_kind="linear")
    src_data = np.stack(list(s_nodal.values()), axis=1)
    old = np.stack(list(t_nodal.values()), axis=1)
    heads = sum(a.nbytes // (4 * hashing.HASH_COLS) * 4 * hashing.HASH_COLS
                for a in (src.points, tgt.points))
    monkeypatch.setenv("MMT_PROFILE", "1")

    def run(device, stored):
        monkeypatch.setattr(tdedup, "_UNIQ_CACHE", {})
        monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
        utils_profile.reset_stages()
        engine.transfer_arrays(
            src.points, src_data, list(s_nodal), tgt.points, old,
            ~fluid.astype(bool), lambda names: np.full(old.shape, np.nan),
            stored_array=stored, device=device)
        counters = utils_profile.counter_totals()
        utils_profile.reset_stages()
        assert "Ignoring stored operator" not in capsys.readouterr().out
        return counters

    assert (hashing.content_fingerprint_device(tgt.points, dev)[0]
            == hashing.content_fingerprint(tgt.points))
    for saver, loader in (("cpu", dev), (dev, "cpu")):
        stored = tmp_path / str(saver)
        saved = run(saver, stored)
        loaded = run(loader, stored)
        assert "dedup.card_rows" not in loaded
        assert "dedup.host_rows" not in loaded
        card = saved if saver == dev else loaded
        assert card["fingerprint.card_bytes"] == heads
        assert card["fingerprint.frozen_hits"] == 0
        # nothing hashed on the host: a build's mesh prep takes the
        # writable source's fingerprint from the identity cache
        assert "fingerprint.host_bytes" not in card


def test_big_endian_arrays_are_fingerprinted_and_transferred_on_card(
        dev, monkeypatch):
    """Coordinates in big-endian f64, as an HDF5 file may hold them:
    ``content_fingerprint_device`` sums their bytes on the card and
    returns ``content_fingerprint``'s value without a typed upload
    (torch has no such dtype), and ``transfer_arrays`` writes bit for bit
    what it writes for the native arrays."""
    from multimesh_tpu_torch import engine

    src, tgt, fluid = _file_pair()
    s_nodal, _ = testing.salvus_fixture_fields(src)
    t_nodal, _ = testing.salvus_fixture_fields(tgt, fluid=fluid,
                                               field_kind="linear")
    src_data = np.stack(list(s_nodal.values()), axis=1)
    old = np.stack(list(t_nodal.values()), axis=1)
    row = 4 * hashing.HASH_COLS
    be = tgt.points.astype(">f8")
    monkeypatch.setenv("MMT_PROFILE", "1")
    utils_profile.reset_stages()
    fp, up = hashing.content_fingerprint_device(be, dev)
    counters = utils_profile.counter_totals()
    utils_profile.reset_stages()
    assert fp == hashing.content_fingerprint(be) and up is None
    assert counters == {"fingerprint.card_bytes": be.nbytes // row * row}

    def run(src_points, tgt_points):
        monkeypatch.setattr(tdedup, "_UNIQ_CACHE", {})
        monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
        sink = np.full(old.shape, np.nan)
        engine.transfer_arrays(
            src_points, src_data, list(s_nodal), tgt_points, old,
            ~fluid.astype(bool), lambda names: sink, device=dev)
        return sink

    native = run(src.points, tgt.points)
    big = run(src.points.astype(">f8"), be)
    np.testing.assert_array_equal(big.view(np.int64), native.view(np.int64))
