"""The port's ``locate`` (the ladder of the main path) against the JAX
package's ``locate(..., engine="xla", strategy="ladder")``.

On the CPU that JAX call takes the same route as its TPU path for
64 < E <= 16,384: nearest-centroid round 1, bucket top-8 rounds 2-3, an
exact k = 20 round 4, and the scan retry of crowded-out rows.  Its Newton
runs f32 bulk iterations plus an f64 polish (convergence at 1e-8), the
port's the f32 kernel schedule (convergence at 1e-4), so refs agree to
f32 grade, not bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.config import LocateConfig  # noqa: E402
from multimesh_tpu.search import locate as jlocate  # noqa: E402
from multimesh_tpu_torch.config import (  # noqa: E402
    LocateConfig as TLocateConfig,
)
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402

N = 4096


@pytest.fixture(scope="module")
def shell():
    """E = 80 > 64: the nearest-centroid ladder.  One sixth of the
    targets are pushed outside the shell (exterior rows exercise the
    fallbacks and overflow the rescue buckets into the scan retry)."""
    mesh = jmt.shell_mesh(n_lat=4, n_lon=5, n_rad=4, order=4)
    rng = np.random.default_rng(11)
    r = rng.uniform(3.6e6, 6.2e6, N)
    th = rng.uniform(0.55, 1.15, N)
    ph = rng.uniform(0.35, 1.35, N)
    pts = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                    r * np.cos(th)], -1)
    pts[: N // 6] *= 1.5  # outside the shell where 1.5 r > 6.371e6
    return mesh, pts, jmt.element_nodal_field(mesh, "smooth")


@pytest.fixture(scope="module")
def jax_ladder(shell):
    """fallback -> the JAX ladder's LocateResult on the shell fixture,
    computed once per module."""
    mesh, pts, _ = shell
    done = {}

    def run(fallback):
        if fallback not in done:
            done[fallback] = jlocate(pts, mesh.points, 4, fallback=fallback,
                                     engine="xla", strategy="ladder")
        return done[fallback]

    return run


def _values(elements, weights, field):
    el = np.asarray(elements)
    vals = np.einsum("pn,pn->p", np.asarray(weights, np.float64),
                     field[np.maximum(el, 0)])
    return np.where(el >= 0, vals, 0.0)


@pytest.mark.parametrize("fallback", ["sentinel", "snap"])
def test_locate_matches_jax(shell, jax_ladder, fallback):
    """``found`` is equal on every row and elements agree on >= 95% of
    rows (exterior snapped rows may pick another equally near boundary
    element).  On rows both accept (the sentinel result's found rows)
    with the same element, interpolated values agree to rtol 1e-5: f32
    refs carry ~1e-7 of the element, far below that."""
    mesh, pts, field = shell
    want = jax_ladder(fallback)
    got = tloc.locate(pts, mesh.points, 4, fallback=fallback, device="cpu")
    assert got.elements.dtype == torch.int32
    assert got.refs.dtype == torch.float32
    assert got.weights.shape == (N, 125)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    ge, we = got.elements.numpy(), np.asarray(want.elements)
    assert (ge == we).mean() >= 0.95
    accepted = np.asarray(jax_ladder("sentinel").found)
    # the scaled rows lie beyond the shell when 1.5 r > r_outer
    assert accepted[N // 6:].all() and not accepted[: N // 6].all()
    same = accepted & (ge == we)
    assert same.mean() > 0.8
    np.testing.assert_allclose(_values(ge, got.weights.numpy(), field)[same],
                               _values(we, want.weights, field)[same],
                               rtol=1e-5)
    # the exterior rows outgrow the rescue buckets: the scan retry ran
    assert got.n_retry > 0


def test_locate_small_mesh_exact_candidates():
    """E <= 64 takes exact top-min(8, E) candidates through the K > 1
    rounds; interior targets all accept, as in the JAX ladder."""
    mesh = jmt.shell_mesh(n_lat=3, n_lon=4, n_rad=2, order=4)  # E = 24
    rng = np.random.default_rng(2)
    r = rng.uniform(3.6e6, 6.2e6, 600)
    th = rng.uniform(0.55, 1.15, 600)
    ph = rng.uniform(0.35, 1.35, 600)
    pts = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                    r * np.cos(th)], -1)
    field = jmt.element_nodal_field(mesh, "smooth")
    want = jlocate(pts, mesh.points, 4, fallback="sentinel", engine="xla",
                   strategy="ladder")
    got = tloc.locate(pts, mesh.points, 4, fallback="sentinel",
                      device="cpu")
    assert got.found.all() and np.asarray(want.found).all()
    ge, we = got.elements.numpy(), np.asarray(want.elements)
    assert (ge == we).mean() >= 0.95
    same = ge == we
    np.testing.assert_allclose(_values(ge, got.weights.numpy(), field)[same],
                               _values(we, want.weights, field)[same],
                               rtol=1e-5)


def test_locate_best_fallback(shell, jax_ladder):
    """The "best" fallback keeps the best converged candidate below
    fallback_max: on the shell fixture it agrees with the JAX ladder
    on ``found`` for >= 99% of rows (exterior rows whose best max |ref|
    sits at 1.5 may flip under f32 vs f64 refs) and on every row the
    sentinel result accepts."""
    mesh, pts, _ = shell
    want = jax_ladder("best")
    got = tloc.locate(pts, mesh.points, 4, fallback="best", device="cpu")
    gf, wf = got.found.numpy(), np.asarray(want.found)
    assert (gf == wf).mean() >= 0.99
    accepted = np.asarray(jax_ladder("sentinel").found)
    assert gf[accepted].all()
    assert (got.elements.numpy()[~gf] == -1).all()


def test_plain_twins_give_the_same_result_on_cpu(shell):
    """``plain=True`` names the twins explicitly; on the CPU they are what
    runs anyway, so the results are identical."""
    mesh, pts, _ = shell
    a = tloc.locate(pts[:1024], mesh.points, 4, fallback="snap",
                    device="cpu")
    b = tloc.locate(pts[:1024], mesh.points, 4, fallback="snap",
                    device="cpu", plain=True)
    for x, y in ((a.elements, b.elements), (a.refs, b.refs),
                 (a.found, b.found)):
        assert torch.equal(x, y)


def test_exterior_heavy_sentinel_skips_retry(shell):
    """Points outside the global source AABB are inside no element: the
    sentinel path drops them from the scan retry, and none is found."""
    mesh, pts, _ = shell
    far = pts[N // 6:N // 6 + 700] * 3.0
    got = tloc.locate(far, mesh.points, 4, fallback="sentinel",
                      device="cpu")
    assert got.n_retry == 0
    assert not got.found.any() and (got.elements == -1).all()
    assert (got.weights == 0).all()


def test_chunking_matches_one_chunk(shell):
    """Chunks are independent ladders whose bucket sizes follow the
    chunk's power-of-two size: two chunks find every interior row the
    single chunk finds, at the same values."""
    mesh, pts, field = shell
    inside = pts[N // 6:N // 6 + 1500]
    one = tloc.locate(inside, mesh.points, 4, device="cpu")
    two = tloc.locate(inside, mesh.points, 4, device="cpu", chunk=1024)
    assert one.found.all() and two.found.all()
    np.testing.assert_allclose(
        _values(two.elements.numpy(), two.weights.numpy(), field),
        _values(one.elements.numpy(), one.weights.numpy(), field),
        rtol=1e-6)


def test_empty_query_set(shell):
    mesh, _, _ = shell
    got = tloc.locate(np.zeros((0, 3)), mesh.points, 4, device="cpu")
    assert got.elements.shape == (0,) and got.refs.shape == (0, 3)
    assert got.weights.shape == (0, 125) and got.found.shape == (0,)


@pytest.mark.parametrize("case", ["fixed_ref", "use_aabb", "prefilter",
                                  "f64_polish", "df32_polish", "grid"])
def test_out_of_slice_options_raise(case):
    """Options outside the ported slice raise NotImplementedError naming
    their ROADMAP item instead of silently taking another path."""
    mesh = jmt.box_mesh(shape=(2, 2, 2), order=1)
    pts = np.full((4, 3), 0.5)
    kw, cfg, nodes = {}, TLocateConfig(), mesh.points
    item = "A4"
    if case == "fixed_ref":
        kw["fallback"] = "fixed_ref"
    elif case == "use_aabb":
        kw["use_aabb"] = True
    elif case == "prefilter":
        kw["prefilter_m"] = 4
    elif case == "f64_polish":
        cfg, item = TLocateConfig(f64_polish=True), "A7"
    elif case == "df32_polish":
        cfg, item = TLocateConfig(df32_polish=True), "A7"
    else:
        nodes, item = np.zeros((16_385, 8, 3)), "A6"
    with pytest.raises(NotImplementedError, match=item):
        tloc.locate(pts, nodes, 1, cfg, device="cpu", **kw)


def test_unknown_fallback_and_device_raise():
    mesh = jmt.box_mesh(shape=(2, 2, 2), order=1)
    pts = np.full((4, 3), 0.5)
    with pytest.raises(ValueError, match="fallback"):
        tloc.locate(pts, mesh.points, 1, fallback="nearest", device="cpu")
    with pytest.raises(ValueError, match="device"):
        tloc.locate(pts, mesh.points, 1, device="meta")


def test_config_matches_jax():
    """The copied dataclass keeps every knob and default."""
    a, b = TLocateConfig(), LocateConfig()
    for f in ("nelem_to_search", "accept_tol", "snap_clip", "fallback_max",
              "newton_iters", "polish_iters", "prefilter_iters",
              "prefilter_pool", "newton_rtol", "newton_clamp",
              "f64_polish", "df32_polish", "df32_polish_iters"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.precision.value == b.precision.value
