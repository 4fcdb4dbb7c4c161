"""``multimesh_tpu_torch.ops.dedup`` against the JAX package's
``ops/dedup.py``: the host dedup is the same numpy, so unique points and
reconstruction indices agree bit for bit; the caches return the same
objects on a hit, hold two entries, and the device copy is keyed by its
device.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.ops import dedup as jdedup  # noqa: E402
from multimesh_tpu_torch.hashing import content_fingerprint  # noqa: E402
from multimesh_tpu_torch.ops import dedup as tdedup  # noqa: E402


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


@pytest.mark.parametrize("order_by", ["sorted", "first"])
@pytest.mark.parametrize("kind",
                         ["shell_3d", "box_2d", "flat_3d", "flat_2d"])
def test_unique_points_equals_jax(kind, order_by):
    pts = _points(kind)
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
