"""``multimesh_tpu_torch.ops.dedup`` against the JAX package's
``ops/dedup.py``: the host dedup is the same numpy, so unique points and
reconstruction indices agree bit for bit, and so do the groupings the
card runs (PyTorch): ``dedup_first`` with the first-appearance order,
``dedup_sorted`` with the sorted one; the caches return the same objects
on a hit, hold two entries, and the device copy is keyed by its device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.ops import dedup as jdedup  # noqa: E402
from multimesh_tpu_torch import testing, utils_profile  # noqa: E402
from multimesh_tpu_torch.hashing import content_fingerprint  # noqa: E402
from multimesh_tpu_torch.ops import dedup as tdedup  # noqa: E402
from multimesh_tpu_torch.ops import layers as tlayers  # noqa: E402


def _points(kind):
    """Seeded inputs with shared nodes: element-nodal [E, n, d] meshes
    (3-D shell, 2-D warped box), their flat [N, d] forms shuffled, and
    random points drawn from a small set of values."""
    if kind == "shell_3d":
        return jmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=4).points
    if kind == "box_2d":
        return jmt.box_mesh(shape=(5, 4), order=2, warp=0.1).points
    rng = np.random.default_rng(7)
    if kind == "flat_3d":
        pts = jmt.shell_mesh(n_lat=3, n_lon=2, n_rad=2, order=2).points
        flat = pts.reshape(-1, 3)
        return flat[rng.permutation(len(flat))]
    if kind == "flat_2d":
        return rng.integers(0, 6, (500, 2)).astype(np.float64) / 4.0
    raise ValueError(kind)


def _twin(pts):
    """``dedup_first`` on the flat points, as numpy."""
    flat = torch.as_tensor(pts.reshape(-1, pts.shape[-1]))
    uniq, recon = tdedup.dedup_first(flat)
    return uniq.numpy(), recon.numpy()


def _assert_bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    bits = f"i{a.itemsize}"
    np.testing.assert_array_equal(a.view(bits), b.view(bits))


# "first_twin": the card's grouping (``dedup_first``), against the first
# order
@pytest.mark.parametrize("order_by", ["sorted", "first", "first_twin"])
@pytest.mark.parametrize("kind",
                         ["shell_3d", "box_2d", "flat_3d", "flat_2d"])
def test_unique_points_equals_jax(kind, order_by):
    pts = _points(kind)
    if order_by == "first_twin":
        uniq, recon = _twin(pts)
        host_uniq, host_recon = tdedup.unique_points(pts, order_by="first")
        _assert_bits_equal(uniq, host_uniq)
        np.testing.assert_array_equal(recon, host_recon)
        order_by = "first"
    else:
        uniq, recon = tdedup.unique_points(pts, order_by=order_by)
    j_uniq, j_recon = jdedup.unique_points(pts, order_by=order_by)
    np.testing.assert_array_equal(uniq, j_uniq)
    np.testing.assert_array_equal(recon, j_recon)
    assert recon.dtype == np.int64 and uniq.dtype == np.float64
    flat = pts.reshape(-1, pts.shape[-1])
    assert len(uniq) < len(flat)  # the inputs do share points
    np.testing.assert_array_equal(uniq[recon], flat)
    assert len(np.unique(uniq, axis=0)) == len(uniq)
    if order_by == "first":
        # every prefix of the input references a prefix of the unique
        # points: the running maximum grows by at most one a slot
        run_max = np.maximum.accumulate(recon)
        assert run_max[0] == 0
        assert (np.diff(run_max) <= 1).all()
        assert (recon <= run_max).all()


@pytest.mark.parametrize("case", testing.DEDUP_EDGE_CASES)
def test_twin_edge_cases_equal_host_bitwise(case):
    """``dedup_first`` and the host path agree bit for bit at the
    grouping's edges, and both follow ``==`` (the JAX package's too)."""
    pts = testing.dedup_edge_points(case)
    uniq, recon = _twin(pts)
    host_uniq, host_recon = tdedup.unique_points(pts, order_by="first")
    j_uniq, j_recon = jdedup.unique_points(pts, order_by="first")
    for u, r in ((host_uniq, host_recon), (j_uniq, j_recon)):
        _assert_bits_equal(uniq, u)
        np.testing.assert_array_equal(recon, r)
    assert recon.dtype == np.int64
    rows = ~np.isnan(pts).any(axis=1)
    assert (uniq[recon][rows] == pts[rows]).all()
    n_groups = {"signed_zero": 2, "nan": 5, "one_row": 1, "all_equal": 1,
                "none_shared": 400}.get(case)
    if n_groups is not None:
        assert len(uniq) == n_groups
    if case == "signed_zero":
        # the group of (0, 1, 0) carries its first row's bits, -0.0 first
        assert np.signbit(uniq[0]).tolist() == [True, False, False]
        assert recon.tolist() == [0, 0, 1, 0, 0]
    if case == "nan":
        assert recon.tolist() == [0, 1, 2, 1, 3, 4]


# the input of each case of ``test_sorted_twin_equals_host_bitwise``
SORTED_CASES = {
    "f64": lambda: _points("flat_3d"),
    "f32": lambda: _points("flat_3d").astype(np.float32),
    "signed_zero": lambda: testing.dedup_edge_points("signed_zero"),
    "one_row": lambda: testing.dedup_edge_points("one_row"),
    "all_equal": lambda: testing.dedup_edge_points("all_equal"),
    "nan": lambda: testing.dedup_edge_points("nan"),
    "across_elements": lambda: _points("shell_3d").astype(np.float32),
    "jax": lambda: _points("box_2d"),
}


@pytest.mark.parametrize("case", list(SORTED_CASES))
def test_sorted_twin_equals_host_bitwise(case):
    """``dedup_sorted`` on CPU tensors (the layered path's grouping on
    the card, on the rows widened to f64 as the card branch widens them)
    against ``unique_points(order_by="sorted")`` on the input as given:
    unique rows cast back to the input's dtype and recon bit for bit;
    for "jax" also against the JAX package's ``unique_points``."""
    pts = SORTED_CASES[case]()
    flat = pts.reshape(-1, pts.shape[-1])
    uniq, recon = tdedup.dedup_sorted(
        torch.as_tensor(flat.astype(np.float64)))
    uniq = uniq.numpy().astype(pts.dtype)
    want_u, want_r = tdedup.unique_points(pts, order_by="sorted")
    _assert_bits_equal(uniq, want_u)
    np.testing.assert_array_equal(recon.numpy(), want_r)
    assert recon.dtype == torch.int64
    if case == "jax":
        j_uniq, j_recon = jdedup.unique_points(pts, order_by="sorted")
        _assert_bits_equal(uniq, j_uniq)
        np.testing.assert_array_equal(recon.numpy(), j_recon)
    rows = ~np.isnan(flat).any(axis=1)
    assert (uniq[recon.numpy()][rows] == flat[rows]).all()
    n_groups = {"signed_zero": 2, "one_row": 1, "all_equal": 1,
                "nan": 5}.get(case)
    if n_groups is not None:
        assert len(uniq) == n_groups
    if case == "signed_zero":
        # sorted: (0, 1, 0) before (2, 0, 0); its first row's bits kept,
        # -0.0 first
        assert np.signbit(uniq[0]).tolist() == [True, False, False]
        assert recon.tolist() == [0, 0, 1, 0, 0]
    if case in ("across_elements", "jax"):
        assert len(uniq) < len(flat)  # elements share their face nodes


@pytest.mark.parametrize("device", [None, "cpu"])
def test_per_layer_dedup_off_the_card_takes_the_host_path(monkeypatch,
                                                          device):
    """``unique_points_per_layer`` without a device or on the CPU runs
    the host lexsort on each layer: numpy arrays equal to
    ``unique_points`` on the layer's elements, counted as host rows."""
    mesh = jmt.shell_mesh(n_lat=3, n_lon=3, n_rad=4, order=2, n_layers=2)
    pts = mesh.points.astype(np.float32)
    masks = tlayers.layer_masks(mesh.layer_id, [2, 1])
    monkeypatch.setenv("MMT_PROFILE", "1")
    utils_profile.reset_stages()
    try:
        got = tdedup.unique_points_per_layer(pts, masks, device=device)
        counters = utils_profile.counter_totals()
    finally:
        utils_profile.reset_stages()
    assert list(got) == ["2", "1"]
    for layer, mask in masks.items():
        want_u, want_r = tdedup.unique_points(pts[mask])
        assert isinstance(got[layer][0], np.ndarray)
        _assert_bits_equal(got[layer][0], want_u)
        np.testing.assert_array_equal(got[layer][1], want_r)
    assert counters == {
        "dedup.host_rows": pts.shape[0] * pts.shape[1],
        "dedup.unique_rows": sum(len(u) for u, _ in got.values())}


def test_device_dedup_on_cpu_takes_the_host_path(monkeypatch):
    """``unique_points_device(device="cpu")`` runs the host lexsort: its
    counters move, the card's does not."""
    monkeypatch.setattr(tdedup, "_UNIQ_CACHE", {})
    monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
    monkeypatch.setenv("MMT_PROFILE", "1")
    pts = _points("box_2d")
    fp = content_fingerprint(pts)  # counts fingerprint.host_bytes
    utils_profile.reset_stages()
    try:
        dev, recon = tdedup.unique_points_device(pts, fp, device="cpu")
        counters = utils_profile.counter_totals()
    finally:
        utils_profile.reset_stages()
    n = pts.shape[0] * pts.shape[1]
    assert counters == {"dedup.host_rows": n, "dedup.unique_rows": len(dev)}
    uniq, want = tdedup.unique_points(pts, order_by="first")
    np.testing.assert_array_equal(dev.numpy(), uniq)
    np.testing.assert_array_equal(recon, want)


def test_card_grouping_of_widened_f32_is_the_host_grouping_of_f32():
    """``unique_points_device``'s CUDA branch widens f32 coordinates to
    f64 before ``dedup_first``: exact, so the groups, their order and
    recon are the host path's on the f32 input, and the unique rows are
    its rows widened."""
    pts = _points("shell_3d").astype(np.float32)
    uniq, recon = _twin(pts.astype(np.float64))
    host_uniq, host_recon = tdedup.unique_points(pts, order_by="first")
    assert host_uniq.dtype == np.float32
    _assert_bits_equal(uniq, host_uniq.astype(np.float64))
    np.testing.assert_array_equal(recon, host_recon)


def test_unknown_order_by_raises():
    with pytest.raises(ValueError, match="order_by"):
        tdedup.unique_points(_points("flat_2d"), order_by="last")


def test_cached_returns_same_objects_and_holds_two_entries(monkeypatch):
    monkeypatch.setattr(tdedup, "_UNIQ_CACHE", {})
    a, b, c = _points("shell_3d"), _points("box_2d"), _points("flat_3d")
    hit_a = tdedup.unique_points_cached(a, order_by="first")
    again = tdedup.unique_points_cached(
        a, fingerprint=content_fingerprint(a), order_by="first")
    assert again[0] is hit_a[0] and again[1] is hit_a[1]
    # another ordering of the same points is another entry
    sorted_a = tdedup.unique_points_cached(a)
    assert sorted_a[0] is not hit_a[0]
    assert len(tdedup._UNIQ_CACHE) == 2
    tdedup.unique_points_cached(b)
    assert len(tdedup._UNIQ_CACHE) == 1  # a third entry clears the two
    tdedup.unique_points_cached(c)
    assert len(tdedup._UNIQ_CACHE) == 2
    fresh = tdedup.unique_points_cached(a, order_by="first")
    assert fresh[0] is not hit_a[0]
    np.testing.assert_array_equal(fresh[1], hit_a[1])


def test_device_copy_is_a_tensor_cached_by_device(monkeypatch):
    monkeypatch.setattr(tdedup, "_UNIQ_CACHE", {})
    monkeypatch.setattr(tdedup, "_UNIQ_DEV_CACHE", {})
    pts = _points("shell_3d")
    fp = content_fingerprint(pts)
    dev, recon = tdedup.unique_points_device(pts, fp, device="cpu")
    assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
    assert dev.dtype == torch.float64
    uniq, want_recon = tdedup.unique_points(pts, order_by="first")
    np.testing.assert_array_equal(dev.numpy(), uniq)
    np.testing.assert_array_equal(recon, want_recon)
    dev2, recon2 = tdedup.unique_points_device(pts, fp, device="cpu")
    assert dev2 is dev and recon2 is recon
    assert list(tdedup._UNIQ_DEV_CACHE) == [(fp, "first", "cpu")]
