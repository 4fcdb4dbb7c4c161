"""The port's balanced-bin search (``search/grid.py``) against the JAX
package's, against ``scipy.spatial.cKDTree`` and against the exact kNN;
and the frozen-array fingerprint cache that keys its index.

The binning is the same host numpy in both packages, so bins are held
bit for bit.  The searches differ in arithmetic only (split-f32 pairs
and ``lax.top_k`` there, f32 / f64 tensors and ``torch.topk`` here), so
they are held by the distance of what they pick, not by index: two
members at the same distance to 1e-5 may swap.
"""
import gc

import numpy as np
import pytest
from scipy.spatial import cKDTree

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.search import grid as jgrid  # noqa: E402
from multimesh_tpu_torch import hashing as thash  # noqa: E402
from multimesh_tpu_torch.search import grid as tgrid  # noqa: E402
from multimesh_tpu_torch.search import knn as tknn  # noqa: E402


def _shell_queries(rng, n):
    r = rng.uniform(3.6e6, 6.3e6, n)
    th = rng.uniform(0.55, 1.15, n)
    ph = rng.uniform(0.35, 1.35, n)
    return np.stack([r * np.sin(th) * np.cos(ph),
                     r * np.sin(th) * np.sin(ph), r * np.cos(th)], -1)


def _dist(src, idx, q):
    return np.linalg.norm(src[np.asarray(idx)] - q[:, None], axis=-1)


@pytest.fixture(scope="module")
def shell_cents():
    return jmt.shell_mesh(n_lat=12, n_lon=16, n_rad=6, order=1).centroids()


@pytest.mark.parametrize("m", [16, 128])
def test_build_grid_matches_jax(shell_cents, m):
    """Bins (members, counts) are identical; representatives agree to
    1e-6 of the mesh's extent (the same f32 mean of the same members);
    the f32 and f64 member planes hold the centred centroids, padding
    slots 1e15."""
    want = jgrid.build_grid(shell_cents, target_per_cell=m)
    got = tgrid.build_grid(shell_cents, target_per_cell=m, device="cpu")
    np.testing.assert_array_equal(got.bin_elems.numpy(),
                                  np.asarray(want.bin_elems))
    np.testing.assert_array_equal(got.bin_counts, want.bin_counts)
    assert got.bin_elems.dtype == torch.int32
    assert got.n_bins == want.n_bins and got.members_per_bin == m
    scale = np.abs(np.asarray(want.bin_reps32)).max()
    np.testing.assert_allclose(got.bin_reps32.numpy(),
                               np.asarray(want.bin_reps32),
                               atol=1e-6 * scale)
    # hi + lo of the JAX pair is the f64 plane; its hi half the f32 one
    c6 = np.asarray(want.bin_coords6, np.float64)
    real = (np.arange(m)[None, :] < got.bin_counts[:, None])[:, None, :]
    real = np.broadcast_to(real, got.bin_coords64.shape)
    np.testing.assert_allclose(got.bin_coords64.numpy()[real],
                               (c6[:, :3] + c6[:, 3:])[real],
                               atol=1e-9 * scale)
    np.testing.assert_array_equal(got.bin_coords32.numpy()[real],
                                  c6[:, :3][real].astype(np.float32))
    assert (got.bin_coords32.numpy()[~real] == np.float32(1e15)).all()
    assert (got.bin_coords64.numpy()[~real] == 1e15).all()
    # every element is in exactly one bin
    members = got.bin_elems.numpy()[real[:, 0, :]]
    np.testing.assert_array_equal(np.sort(members),
                                  np.arange(shell_cents.shape[0]))


def test_grid_knn_matches_exact_uniform(rng):
    """The fixture of the JAX package's test: 20,000 uniform sources, 10
    neighbours, 8 probed 128-member bins; by distance against cKDTree and
    against the JAX ``grid_knn``, rtol 1e-5."""
    src = rng.uniform(-1, 1, size=(20000, 3))
    q = rng.uniform(-0.9, 0.9, size=(500, 3))
    d_ref = cKDTree(src).query(q, k=10)[0]
    index = tgrid.build_grid(src, device="cpu")
    d2, idx = tgrid.grid_knn(index, torch.from_numpy(q), 10)
    assert d2.dtype == torch.float64 and idx.dtype == torch.int32
    assert d2.shape == idx.shape == (500, 10)
    np.testing.assert_allclose(_dist(src, idx, q), d_ref, rtol=1e-5,
                               atol=1e-9)
    np.testing.assert_allclose(np.sqrt(d2.numpy()), d_ref, rtol=1e-9,
                               atol=1e-12)
    _, j_idx = jgrid.grid_knn(jgrid.build_grid(src), q, 10)
    np.testing.assert_allclose(_dist(src, idx, q), _dist(src, j_idx, q),
                               rtol=1e-5, atol=1e-9)


def test_grid_knn_on_shell_centroids(shell_cents, rng):
    """16-member bins, 16 probes, on the anisotropic shell."""
    q = _shell_queries(rng, 300)
    index = tgrid.build_grid(shell_cents, target_per_cell=16, device="cpu")
    _, idx = tgrid.grid_knn(index, torch.from_numpy(q), 8, n_probe=16)
    d_ref = cKDTree(shell_cents).query(q, k=8)[0]
    np.testing.assert_allclose(_dist(shell_cents, idx, q), d_ref,
                               rtol=1e-5, atol=1.0)
    _, j_idx = jgrid.grid_knn(
        jgrid.build_grid(shell_cents, target_per_cell=16), q, 8, n_probe=16)
    np.testing.assert_allclose(_dist(shell_cents, idx, q),
                               _dist(shell_cents, j_idx, q), rtol=1e-5,
                               atol=1.0)


@pytest.mark.parametrize("n_probe", [1, 4])
def test_nearest_member_matches_jax(shell_cents, rng, n_probe):
    """Round 1's single candidate: the member both packages choose lies
    at the same distance on every row (f32 ranking in both: rtol 1e-5),
    is never nearer than the exact nearest, and with 4 probed bins is the
    exact nearest on >= 97% of rows."""
    q = _shell_queries(rng, 2000)
    got = tgrid.nearest_member(
        tgrid.build_grid(shell_cents, target_per_cell=16, device="cpu"),
        torch.from_numpy(q), n_probe=n_probe)
    want = jgrid.nearest_member(
        jgrid.build_grid(shell_cents, target_per_cell=16), q,
        n_probe=n_probe)
    assert got.dtype == torch.int32 and got.shape == (2000,)
    d_got = _dist(shell_cents, got.numpy()[:, None], q)[:, 0]
    d_want = _dist(shell_cents, np.asarray(want)[:, None], q)[:, 0]
    np.testing.assert_allclose(d_got, d_want, rtol=1e-5)
    d_ref, i_ref = cKDTree(shell_cents).query(q, k=1)
    assert (d_got >= d_ref * (1 - 1e-6)).all()
    if n_probe == 4:
        assert (got.numpy() == i_ref).mean() >= 0.97


def test_probe_topk_ranks_as_grid_knn(shell_cents, rng):
    """The in-ladder probes rank in f32: the same members as the f64
    ``grid_knn`` of the same bins, by distance to rtol 1e-5; fewer probed
    slots than k repeat the last column."""
    q = torch.from_numpy(_shell_queries(rng, 500))
    index = tgrid.build_grid(shell_cents, target_per_cell=32, device="cpu")
    got = tgrid.probe_topk(index, q, 12, 2)
    _, want = tgrid.grid_knn(index, q, 12, n_probe=2)
    np.testing.assert_allclose(_dist(shell_cents, got, q.numpy()),
                               _dist(shell_cents, want, q.numpy()),
                               rtol=1e-5)
    d2, idx = tgrid.grid_knn(index, q, 40, n_probe=1)
    assert idx.shape == (500, 40)
    assert (idx[:, 32:] == idx[:, 31:32]).all()
    assert (d2[:, 32:] == d2[:, 31:32]).all()


def test_row_blocks_give_the_same_result(shell_cents, rng, monkeypatch):
    """Queries run in row blocks that bound the score block and the member
    gather; the block size does not change a result."""
    q = torch.from_numpy(_shell_queries(rng, 700))
    index = tgrid.build_grid(shell_cents, target_per_cell=16, device="cpu")
    d_one, i_one = tgrid.grid_knn(index, q, 8)
    monkeypatch.setattr(tgrid, "_BLOCK_ENTRIES", 8 * 3 * 16 * 64)
    d_blk, i_blk = tgrid.grid_knn(index, q, 8)  # 64 rows a block
    assert torch.equal(i_one, i_blk) and torch.equal(d_one, d_blk)
    empty = tgrid.grid_knn(index, q[:0], 8)
    assert empty[0].shape == empty[1].shape == (0, 8)


def test_knn_any_dispatch(rng):
    """Exact below 131,072 sources, the grid above (200,000 random
    sources).  Distances ascend and the first column is the true
    nearest."""
    q = rng.uniform(0, 1, size=(100, 3))
    q_t = torch.from_numpy(q)
    src = rng.uniform(0, 1, size=(500, 3))
    d2, idx = tgrid.knn_any(torch.from_numpy(src), q_t, 5)
    np.testing.assert_allclose(np.sqrt(d2.numpy()),
                               cKDTree(src).query(q, k=5)[0], rtol=1e-6)

    big = rng.uniform(0, 1, size=(200000, 3))
    big_t = torch.from_numpy(big)
    tgrid._INDEX_CACHE.clear()
    d2, idx = tgrid.knn_any(big_t, q_t, 5)
    assert len(tgrid._INDEX_CACHE) == 1  # took the grid
    d_ref, i_ref = cKDTree(big).query(q, k=5)
    np.testing.assert_allclose(np.sqrt(d2.numpy()), d_ref, rtol=1e-5,
                               atol=1e-9)
    assert (np.diff(d2.numpy(), axis=1) >= 0).all()
    assert (idx.numpy()[:, 0] == i_ref[:, 0]).all()
    # the same through the host copy of the sources: one index, reused
    big.setflags(write=False)
    d2_h, idx_h = tgrid.knn_any(big_t, q_t, 5, sources_host=big)
    assert torch.equal(idx_h, idx) and len(tgrid._INDEX_CACHE) == 1

    mid = rng.uniform(0, 1, size=(20000, 3))
    mid_t = torch.from_numpy(mid)
    tgrid._INDEX_CACHE.clear()
    _, i_exact = tgrid.knn_any(mid_t, q_t, 5)
    assert not tgrid._INDEX_CACHE  # exact: no index was built
    assert torch.equal(i_exact, tknn.knn(mid_t, q_t, 5)[1])


def test_get_grid_index_is_cached_by_content(rng):
    """One index per (content, bin size, device); a changed array gets a
    new one."""
    src = rng.uniform(0, 1, size=(3000, 3))
    a = tgrid.get_grid_index(src, 64, "cpu")
    assert tgrid.get_grid_index(src.copy(), 64, "cpu") is a
    assert tgrid.get_grid_index(src, 32, "cpu") is not a
    src[5, 1] += 0.25
    b = tgrid.get_grid_index(src, 64, "cpu")
    assert b is not a
    src.setflags(write=False)
    assert tgrid.get_grid_index(src, 64, "cpu") is b
    assert id(src) in thash._FROZEN_CACHE


def test_fingerprint_frozen_identity_cache(rng):
    """Read-only host arrays are hashed once and then served from the
    identity cache; other content gets another fingerprint; unfreeze,
    mutate, refreeze trips the guard digest."""
    arr = rng.random((512, 4))
    fp_writable = thash.array_fingerprint(arr)
    assert fp_writable == thash.content_fingerprint(arr)
    assert id(arr) not in thash._FROZEN_CACHE  # writable: never cached
    arr.setflags(write=False)
    fp_frozen = thash.array_fingerprint(arr)
    assert fp_frozen == fp_writable
    assert thash._FROZEN_CACHE[id(arr)][0]() is arr  # held by weakref

    other = arr.copy()
    other[3, 1] += 1.0
    other.setflags(write=False)
    assert thash.array_fingerprint(other) != fp_frozen

    arr.setflags(write=True)
    arr[7, 2] += 3.0
    arr.setflags(write=False)
    fp_new = thash.array_fingerprint(arr)
    assert fp_new != fp_frozen
    assert fp_new == thash.content_fingerprint(arr)


def test_fingerprint_cache_serves_hits_and_frees_arrays(rng, monkeypatch):
    """A hit does not hash again, and the cache does not keep a GB-scale
    mesh alive: it holds a weak reference."""
    arr = rng.random((2048, 3))
    arr.setflags(write=False)
    fp = thash.array_fingerprint(arr)
    calls = []
    real = thash.content_hash
    monkeypatch.setattr(thash, "content_hash",
                        lambda a: calls.append(1) or real(a))
    assert thash.array_fingerprint(arr) == fp and not calls
    assert thash.array_fingerprint(arr.copy()) == fp and calls
    key = id(arr)
    del arr
    gc.collect()
    assert thash._FROZEN_CACHE[key][0]() is None


def test_spatial_order_matches_jax(shell_cents, rng):
    """The permutation is the JAX package's bit for bit (the same host
    median split), on shell centroids and on random points."""
    for cents in (shell_cents, rng.normal(size=(3001, 3)),
                  rng.uniform(size=(700, 2))):
        got = tgrid.spatial_order(cents)
        want = jgrid.spatial_order(cents)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.sort(got), np.arange(len(cents)))
