"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card.  Every test here carries the ``cuda`` marker and skips without a
CUDA device (so on a CPU-only machine they count as skips, not passes).

This file imports only torch and the port -- no JAX -- so it runs on a
machine without JAX; ``tests/conftest.py`` imports JAX, so run it there
with ``--noconftest``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu_torch import TransferOperator, testing  # noqa: E402
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402
from multimesh_tpu_torch.search import nearest, newton  # noqa: E402

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("order,dim", [(1, 2), (1, 3), (2, 2), (2, 3),
                                       (4, 2), (4, 3)])
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
