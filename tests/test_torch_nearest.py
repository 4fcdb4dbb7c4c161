"""K2, the nearest-centroid kernel: its plain PyTorch twin against the JAX
Pallas kernel ``_nearest_pallas_jit`` in interpret mode and against
``knn._nearest_jit``, plus the exact kNN and the rescue top-k of the
port's ``search.knn``.

Every side ranks by ``|c|^2 - 2 q.c`` in f32 on coordinates centred
jointly on the sources' mean, so picks are compared by the distance of
the chosen source (the rule of the JAX package's own test, test_knn.py):
f32 rank noise only ever swaps near-ties.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from multimesh_tpu.search.pallas_argmin import (  # noqa: E402
    _nearest_pallas_jit,
)
from multimesh_tpu_torch.search import knn as tknn  # noqa: E402
from multimesh_tpu_torch.search import nearest as tnearest  # noqa: E402

# the module, not the ``knn`` function that multimesh_tpu.search re-exports
jknn = importlib.import_module("multimesh_tpu.search.knn")


def _cloud(d, E=300, C=700, seed=0):
    rng = np.random.default_rng(seed + d)
    src = rng.uniform(-6.4e6, 6.4e6, size=(E, d))
    q = rng.uniform(-6.0e6, 6.0e6, size=(C, d))
    return src, q


def _d2(q, src, idx):
    return np.sum((q - src[idx]) ** 2, axis=-1)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("other", ["pallas_interpret", "xla"])
def test_twin_matches_jax(d, other):
    """Distance-equivalent picks (rtol 1e-3, atol 1 m^2: the JAX test's
    bound for f32 ranking noise at Earth scale) and the same index on
    more than 99% of queries."""
    src, q = _cloud(d)
    if other == "pallas_interpret":
        want = np.asarray(_nearest_pallas_jit(jnp.asarray(q),
                                              jnp.asarray(src),
                                              interpret=True))
    else:
        want = np.asarray(jknn._nearest_jit(jnp.asarray(q),
                                            jnp.asarray(src)))
    got = tnearest.nearest_centroid_ref(torch.from_numpy(q),
                                        torch.from_numpy(src)).numpy()
    assert got.dtype == np.int32 and got.shape == (q.shape[0],)
    assert got.min() >= 0 and got.max() < src.shape[0]
    np.testing.assert_allclose(_d2(q, src, got), _d2(q, src, want),
                               rtol=1e-3, atol=1.0)
    assert (got == want).mean() > 0.99


def test_twin_is_near_exact():
    """Against the f64 brute-force nearest: the f32 score's rounding at
    these magnitudes is ~1e6 m^2 (ulp of |c|^2 ~ 1e13), so the chosen
    distance is within that of the true minimum."""
    src, q = _cloud(3, E=500, C=900, seed=4)
    got = tnearest.nearest_centroid_ref(torch.from_numpy(q),
                                        torch.from_numpy(src)).numpy()
    exact = np.argmin(((q[:, None] - src[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_allclose(_d2(q, src, got), _d2(q, src, exact),
                               rtol=0, atol=4e6)


def test_lowest_index_wins_ties():
    """Duplicate sources: the lower index is picked, as argmin does."""
    src = np.array([[1.0, 0.0, 0.0], [0.0, 2.0, 0.0], [1.0, 0.0, 0.0]])
    q = np.array([[1.1, 0.0, 0.0], [0.9, 0.1, 0.0]])
    got = tnearest.nearest(torch.from_numpy(q), torch.from_numpy(src))
    assert got.tolist() == [0, 0]


def test_nearest_centroid_chunks_and_counts():
    """The chunk loop gives the one-shot answer, and on the CPU it runs
    the twin without counting a kernel launch."""
    src, q = _cloud(3, E=200, C=1000, seed=9)
    qt, st = torch.from_numpy(q), torch.from_numpy(src)
    before = tnearest.nearest.launches
    chunked = tknn.nearest_centroid(st, qt, query_chunk=128)
    assert tnearest.nearest.launches == before
    assert torch.equal(chunked, tnearest.nearest_centroid_ref(qt, st))
    assert tknn.nearest_centroid(st, qt[:0]).shape == (0,)


def test_nearest_rejects_bad_input():
    src, q = _cloud(3, E=10, C=10)
    qt, st = torch.from_numpy(q), torch.from_numpy(src)
    with pytest.raises(ValueError):
        tnearest.nearest(qt.float(), st)
    with pytest.raises(ValueError):
        tnearest.nearest(qt, st[:, :2].contiguous())
    with pytest.raises(ValueError):
        tnearest.nearest(qt, st[:0])
    with pytest.raises(ValueError, match="unsupported device"):
        tnearest.nearest(qt.to("meta"), st.to("meta"))


@pytest.mark.parametrize("k,E", [(20, 300), (8, 5)])
def test_knn_matches_jax(k, E):
    """Exact kNN: the JAX two-stage search re-ranks in split-f32 and the
    port ranks in f64, so the sorted distances agree to 1e-6 relative
    and the index sets agree except at exact ties.  With fewer sources
    than k the last column repeats, as in the JAX package."""
    src, q = _cloud(3, E=E, C=400, seed=2)
    wd, wi = jknn.knn(src, q, k)
    gd, gi = tknn.knn(torch.from_numpy(src), torch.from_numpy(q), k)
    assert gi.dtype == torch.int32 and gi.shape == (400, k)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-6)
    assert (gi.numpy() == np.asarray(wi)).mean() > 0.999
    d = gd.numpy()
    assert (np.diff(d, axis=1) >= 0).all()


def test_centred_topk_matches_brute_force():
    """The rescue rounds' top-8 over f32 centred centroids: the same
    columns as an f64 brute-force sort, up to f32 near-ties (compared by
    distance, 1e6 m^2 as above)."""
    src, q = _cloud(3, E=400, C=300, seed=6)
    st = torch.from_numpy(src)
    center = st.mean(dim=0)
    sc = (st - center).to(torch.float32)
    got = tknn.centred_topk(sc, torch.from_numpy(q), center, 8).numpy()
    exact = np.argsort(((q[:, None] - src[None]) ** 2).sum(-1), axis=1)[:, :8]
    assert got.shape == (300, 8) and got.dtype == np.int32
    np.testing.assert_allclose(
        np.take_along_axis(((q[:, None] - src[None]) ** 2).sum(-1), got, 1),
        np.take_along_axis(((q[:, None] - src[None]) ** 2).sum(-1), exact, 1),
        rtol=0, atol=4e6)
