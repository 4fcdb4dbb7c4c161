"""The port's ``locate`` against the JAX package's ``locate(...,
engine="xla")``: the ladder (``strategy="ladder"``) with every fallback,
``use_aabb`` and the polish options, and the scan (``strategy="scan"``)
with the trilinear prefilter.

On the CPU the JAX ladder takes the same route as its TPU path for
64 < E <= 16,384: nearest-centroid round 1, bucket top-8 rounds 2-3, an
exact k = 20 round 4, and the scan retry of crowded-out rows.  Above
``grid.APPROX_GRID_MIN_SOURCES`` both packages take the grid route
(nearest-member round 1, probed rescue rounds); the grid tests lower that
threshold in both so that a 1,024-element source takes it.  Its Newton
runs f32 bulk iterations plus an f64 polish (convergence at 1e-8), the
port's the f32 kernel schedule (convergence at 1e-4), so unpolished refs
agree to f32 grade, not bitwise; polished refs agree to 1e-10.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.config import LocateConfig  # noqa: E402
from multimesh_tpu.search import locate as jlocate  # noqa: E402
# the module (the package's ``locate`` name is the function)
jlocate_mod = importlib.import_module("multimesh_tpu.search.locate")
jgrid_mod = importlib.import_module("multimesh_tpu.search.grid")
from multimesh_tpu_torch.config import (  # noqa: E402
    LocateConfig as TLocateConfig,
)
from multimesh_tpu_torch.config import FALLBACK_REF_COORD  # noqa: E402
from multimesh_tpu_torch import utils_profile as tprofile  # noqa: E402
from multimesh_tpu_torch.search import grid as tgrid  # noqa: E402
from multimesh_tpu_torch.search import knn as tknn  # noqa: E402
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
def jax_run(shell):
    """(strategy, fallback, use_aabb, prefilter_m) -> the JAX package's
    xla LocateResult on the shell fixture, computed once per module."""
    mesh, pts, _ = shell
    done = {}

    def run(strategy, fallback, use_aabb=False, prefilter_m=0):
        key = (strategy, fallback, use_aabb, prefilter_m)
        if key not in done:
            done[key] = jlocate(pts, mesh.points, 4, fallback=fallback,
                                use_aabb=use_aabb, prefilter_m=prefilter_m,
                                engine="xla", strategy=strategy)
        return done[key]

    return run


@pytest.fixture(scope="module")
def jax_ladder(jax_run):
    """fallback -> the JAX ladder's LocateResult on the shell fixture."""
    return lambda fallback: jax_run("ladder", fallback)


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


def test_unknown_fallback_and_device_raise():
    mesh = jmt.box_mesh(shape=(2, 2, 2), order=1)
    pts = np.full((4, 3), 0.5)
    with pytest.raises(ValueError, match="fallback"):
        tloc.locate(pts, mesh.points, 1, fallback="nearest", device="cpu")
    with pytest.raises(ValueError, match="device"):
        tloc.locate(pts, mesh.points, 1, device="meta")
    with pytest.raises(ValueError, match="strategy"):
        tloc.locate(pts, mesh.points, 1, strategy="grid", device="cpu")


def test_config_matches_jax():
    """The copied dataclass keeps every knob and default."""
    a, b = TLocateConfig(), LocateConfig()
    for f in ("nelem_to_search", "accept_tol", "snap_clip", "fallback_max",
              "newton_iters", "polish_iters", "prefilter_iters",
              "prefilter_pool", "newton_rtol", "newton_clamp",
              "f64_polish", "df32_polish", "df32_polish_iters"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.precision.value == b.precision.value


@pytest.mark.parametrize("fallback,use_aabb", [("fixed_ref", True),
                                               ("fixed_ref", False),
                                               ("sentinel", True)])
def test_fixed_ref_and_aabb_match_jax(shell, jax_run, fallback, use_aabb):
    """``fixed_ref`` (the scan retry's first-in-AABB / nearest-centre
    fallback for every row the ladder leaves unaccepted) and the AABB
    accept test, against the JAX ladder: elements and found identical on
    every row, refs to f32 grade (1e-5; fixed refs are stored in f32)."""
    mesh, pts, _ = shell
    want = jax_run("ladder", fallback, use_aabb)
    got = tloc.locate(pts, mesh.points, 4, fallback=fallback,
                      use_aabb=use_aabb, device="cpu")
    np.testing.assert_array_equal(got.elements.numpy(),
                                  np.asarray(want.elements))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    np.testing.assert_allclose(got.refs.numpy(), np.asarray(want.refs),
                               atol=1e-5)
    unaccepted = ~got.accepted
    assert got.n_retry > 0
    if fallback == "fixed_ref":
        # every unaccepted row took the scan retry; the far exterior
        # rows of this fixture converge nowhere and take the fixed ref
        assert got.found.all() and got.n_retry >= int(unaccepted.sum())
        fixed = torch.tensor(FALLBACK_REF_COORD, dtype=torch.float32)
        assert (got.refs[unaccepted] == fixed).all(dim=-1).any()
    else:
        assert torch.equal(got.accepted, got.found)


@pytest.mark.parametrize("fallback,use_aabb", [("sentinel", False),
                                               ("fixed_ref", True)])
def test_scan_prefilter_matches_jax(shell, jax_run, fallback, use_aabb):
    """``strategy="scan"`` with ``prefilter_m=4`` against the JAX scan.
    The JAX xla prefilter judges convergence at 1e-8 on an f64 residual,
    which its 8 f32 steps never reach, so it keeps the 4 nearest
    candidates; the port's ranks them by K1 at order 1 on the corners
    (convergence at 1e-4).  Both rescue every row they leave unaccepted
    with the full list, so they can differ only where two elements accept
    a point near their shared face: elements agree on >= 99.9% of rows,
    found on all, refs to 1e-5 where elements agree."""
    mesh, pts, _ = shell
    want = jax_run("scan", fallback, use_aabb, 4)
    got = tloc.locate(pts, mesh.points, 4, fallback=fallback,
                      use_aabb=use_aabb, prefilter_m=4, strategy="scan",
                      device="cpu")
    ge, we = got.elements.numpy(), np.asarray(want.elements)
    assert (ge == we).mean() >= 0.999
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    same = ge == we
    np.testing.assert_allclose(got.refs.numpy()[same],
                               np.asarray(want.refs)[same], atol=1e-5)
    assert got.n_retry == 0
    # the scan accepts what the ladder accepts
    ladder = tloc.locate(pts, mesh.points, 4, fallback=fallback,
                         use_aabb=use_aabb, device="cpu")
    assert torch.equal(got.accepted, ladder.accepted)


def test_prefilter_rank_keeps_distance_order():
    """``_prefilter_rank`` keeps ``m`` of the candidate columns, in their
    distance order, and the element that holds the point survives."""
    mesh = jmt.box_mesh(shape=(4, 4, 4), order=2, warp=0.1)
    prep = tloc._mesh_prep(mesh.points, 2, "cpu")
    pts = torch.as_tensor(
        np.random.default_rng(4).uniform(0.05, 0.95, (300, 3)))
    cand = tknn.knn(prep.centroids, pts, 12)[1]
    solve1 = tloc._row_solver(prep, prep.corners, 1, 3, 8, 8.0, False)
    kept = tloc._prefilter_rank(pts, cand, solve1, 4)
    assert kept.shape == (300, 4)
    pos = (kept[:, :, None] == cand[:, None, :]).int().argmax(dim=-1)
    assert (pos[:, 1:] > pos[:, :-1]).all()
    holder = tloc.locate(pts, mesh.points, 2, device="cpu")
    assert holder.found.all()
    assert (kept == holder.elements[:, None]).any(dim=1).all()


def test_prefilter_rank_matches_jax_pallas(shell):
    """The ranking itself against the JAX package's TPU route: its
    ``_prefilter_rank`` driven by ``_make_pallas_invert`` on
    ``corners_c32`` at order 1 (K3 in interpret mode, 8 steps), the port's
    by the K1 twin on ``corners32``, on the same 12 candidate columns of
    1,024 points (a third of them outside the shell).  Centring differs
    in rounding only (split f32 there, f64 here): the scores (max |ref|,
    inf where unconverged) converge on the same pairs and agree to 1e-5.
    The shell's symmetric neighbours tie to an ulp, so a tie at the m-th
    place may keep either column: the kept columns score the same to
    1e-5 on every row, and are the same columns in the same order on
    every row whose m-th and (m+1)-th scores are more than 1e-5 apart."""
    mesh, pts, _ = shell
    pts = pts[N // 6 - 341:N // 6 + 683]
    n = pts.shape[0]
    cfg = LocateConfig()
    prep = tloc._mesh_prep(mesh.points, 4, "cpu")
    pool, m = cfg.prefilter_pool, 4
    cand = tknn.knn(prep.centroids, torch.from_numpy(pts), pool)[1]
    solve1 = tloc._row_solver(prep, prep.corners, 1, 3, cfg.prefilter_iters,
                              cfg.newton_clamp, False)
    got = tloc._prefilter_rank(torch.from_numpy(pts), cand, solve1,
                               m).numpy()
    ref, res = solve1(torch.from_numpy(pts).repeat(pool, 1),
                      cand.T.reshape(-1))
    t_score = torch.where(res < 1e-4, ref.abs().amax(-1), float("inf")
                          ).view(pool, n).T.numpy()

    jprep = jlocate_mod._mesh_prep_host(mesh.points, 4, 3, True)
    cfg1 = dataclasses.replace(cfg, newton_iters=cfg.prefilter_iters,
                               polish_iters=0)
    invert1 = jlocate_mod._make_pallas_invert(
        jnp.asarray(pts), jprep["corners_c32"], jprep["centering"], 1, cfg1,
        interpret=True)
    j_cand = jnp.asarray(cand.numpy())
    want = np.asarray(jlocate_mod._prefilter_rank(j_cand, invert1, m, pool))
    j_score = np.stack([np.where(c, mx, np.inf) for _, c, mx in (
        invert1(j_cand[:, k]) for k in range(pool))], axis=1)

    conv = np.isfinite(j_score)
    np.testing.assert_array_equal(np.isfinite(t_score), conv)
    assert conv[341:].any(axis=1).all()  # interior rows converge somewhere
    np.testing.assert_allclose(t_score[conv], j_score[conv], atol=1e-5)

    def kept_scores(kept):
        pos = (kept[:, :, None] == cand.numpy()[:, None, :]).argmax(-1)
        return np.sort(np.take_along_axis(j_score, pos, 1), axis=1)

    assert got.shape == want.shape == (n, m)
    g, w = kept_scores(got), kept_scores(want)
    np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
    np.testing.assert_allclose(g[np.isfinite(g)], w[np.isfinite(w)],
                               atol=1e-5)
    ranked = np.sort(j_score, axis=1)
    with np.errstate(invalid="ignore"):  # inf - inf: a tie, not clear
        clear = ranked[:, m] - ranked[:, m - 1] > 1e-5
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[clear], want[clear])
    # the ranking is no distance cut: some rows keep a farther column
    assert (got != cand.numpy()[:, :m]).any()


def test_prefilter_is_ignored_on_the_ladder(shell):
    """As in the JAX package, the ladder takes ``prefilter_m`` and runs
    as without it."""
    mesh, pts, _ = shell
    a = tloc.locate(pts[:1024], mesh.points, 4, fallback="snap",
                    device="cpu")
    b = tloc.locate(pts[:1024], mesh.points, 4, fallback="snap",
                    prefilter_m=4, device="cpu")
    for x, y in ((a.elements, b.elements), (a.refs, b.refs),
                 (a.found, b.found), (a.accepted, b.accepted)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("polish", ["df32", "f64"])
def test_polished_refs_match_jax_f64(shell, jax_ladder, polish):
    """The df32 pair (refs + refs_lo, through the K4 twin) and the
    f64-polished refs both agree with the JAX xla ladder's f64 refs to
    1e-10 on every accepted row (all interior rows here); rows the
    polish skips keep their f32 refs."""
    mesh, pts, _ = shell
    want = jax_ladder("snap")
    cfg = TLocateConfig(df32_polish=polish == "df32",
                        f64_polish=polish == "f64")
    got = tloc.locate(pts, mesh.points, 4, cfg, fallback="snap",
                      device="cpu")
    plain = tloc.locate(pts, mesh.points, 4, fallback="snap", device="cpu")
    acc = got.accepted.numpy()
    assert acc[N // 6:].all()
    assert (got.elements.numpy()[acc] == np.asarray(want.elements)[acc]
            ).all()
    if polish == "df32":
        assert got.refs.dtype == torch.float32
        refs = got.refs.double() + got.refs_lo.double()
        assert (got.refs_lo[~got.accepted] == 0).all()
    else:
        assert got.refs_lo is None and got.refs.dtype == torch.float64
        refs = got.refs
    np.testing.assert_allclose(refs.numpy()[acc], np.asarray(want.refs)[acc],
                               rtol=0, atol=1e-10)
    assert torch.equal(refs[~got.accepted],
                       plain.refs[~got.accepted].double())


def test_scan_skips_polish_with_a_warning(shell):
    """The polish runs on the ladder only: the scan warns and skips it."""
    mesh, pts, _ = shell
    with pytest.warns(UserWarning, match="ladder only"):
        got = tloc.locate(pts[N // 6:N // 6 + 64], mesh.points, 4,
                          TLocateConfig(df32_polish=True), strategy="scan",
                          device="cpu")
    assert got.refs_lo is None and got.refs.dtype == torch.float32


# ---- the grid route (sources above grid.APPROX_GRID_MIN_SOURCES) ---------

N_GRID = 2000


@pytest.fixture(scope="module")
def grid_shell():
    """E = 1,024 in 32 bins of 32 members, so every probe is partial (4
    of 32 bins in round 1, 8 in rounds 2-3, 64 -> all only in round 4);
    one tenth of the targets lie outside the shell (the snapped rows
    among them are the ones that may pick another element: their
    best-so-far is judged by f64 convergence at 1e-8 there, f32 at 1e-4
    here)."""
    mesh = jmt.shell_mesh(n_lat=16, n_lon=16, n_rad=4, order=2)
    rng = np.random.default_rng(21)
    r = rng.uniform(3.6e6, 6.2e6, N_GRID)
    th = rng.uniform(0.55, 1.15, N_GRID)
    ph = rng.uniform(0.35, 1.35, N_GRID)
    pts = np.stack([r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
                    r * np.cos(th)], -1)
    pts[: N_GRID // 10] *= 1.5
    return mesh, pts, jmt.element_nodal_field(mesh, "smooth")


@pytest.fixture
def grid_route(monkeypatch):
    """Both packages' ladders on the grid route for E > 64, with
    32-member round-1 bins.  Both read the threshold when called."""
    monkeypatch.setattr(jgrid_mod, "APPROX_GRID_MIN_SOURCES", 64)
    monkeypatch.setenv("MMT_R1_M", "32")
    monkeypatch.setattr(tgrid, "APPROX_GRID_MIN_SOURCES", 64)
    monkeypatch.setattr(tloc, "ROUND1_MEMBERS", 32)


@pytest.mark.parametrize("fallback", ["sentinel", "snap"])
def test_grid_ladder_matches_jax(grid_shell, grid_route, fallback):
    """The grid ladder held as ``test_locate_matches_jax`` holds the small
    route: ``found`` equal on every row, elements on >= 95%, values to
    rtol 1e-5 on rows both accept with the same element."""
    mesh, pts, field = grid_shell
    want = jlocate(pts, mesh.points, 2, fallback=fallback, engine="xla",
                   strategy="ladder")
    tgrid._INDEX_CACHE.clear()
    got = tloc.locate(pts, mesh.points, 2, fallback=fallback, device="cpu")
    (index,) = tgrid._INDEX_CACHE.values()  # the route probed its index
    assert index.members_per_bin == 32 and index.n_bins == 32
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    ge, we = got.elements.numpy(), np.asarray(want.elements)
    assert (ge == we).mean() >= 0.95
    accepted = got.accepted.numpy()
    assert accepted[N_GRID // 10:].all() and not accepted[: N_GRID // 10].all()
    if fallback == "sentinel":
        np.testing.assert_array_equal(accepted, np.asarray(want.found))
    same = accepted & (ge == we)
    assert same.mean() > 0.8
    np.testing.assert_allclose(_values(ge, got.weights.numpy(), field)[same],
                               _values(we, want.weights, field)[same],
                               rtol=1e-5)


def test_grid_ladder_fixed_ref_and_aabb_match_jax(grid_shell, grid_route):
    """``fixed_ref`` + ``use_aabb`` over the grid route: every unaccepted
    row takes the scan retry in both packages, so elements and found are
    identical to the JAX ladder's, refs to f32 grade."""
    mesh, pts, _ = grid_shell
    want = jlocate(pts, mesh.points, 2, fallback="fixed_ref", use_aabb=True,
                   engine="xla", strategy="ladder")
    got = tloc.locate(pts, mesh.points, 2, fallback="fixed_ref",
                      use_aabb=True, device="cpu")
    np.testing.assert_array_equal(got.elements.numpy(),
                                  np.asarray(want.elements))
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    np.testing.assert_allclose(got.refs.numpy(), np.asarray(want.refs),
                               atol=1e-5)
    assert got.found.all() and got.n_retry >= int((~got.accepted).sum()) > 0


def test_grid_ladder_accepts_what_the_exact_ladder_accepts(grid_shell,
                                                           grid_route,
                                                           monkeypatch):
    """The route is a matter of cost, not of result: on the same source
    the grid ladder and the exact-search ladder accept the same rows, in
    the same elements on >= 99%, and a df32 polish runs on either."""
    mesh, pts, _ = grid_shell
    cfg = TLocateConfig(df32_polish=True)
    via_grid = tloc.locate(pts, mesh.points, 2, cfg, device="cpu")
    monkeypatch.setattr(tgrid, "APPROX_GRID_MIN_SOURCES", 16_384)
    exact = tloc.locate(pts, mesh.points, 2, cfg, device="cpu")
    assert torch.equal(via_grid.accepted, exact.accepted)
    assert (via_grid.elements == exact.elements).double().mean() >= 0.99
    assert via_grid.refs_lo is not None
    assert (via_grid.refs_lo[via_grid.accepted] != 0).any()


def test_scan_above_exact_knn_limit_matches_jax(grid_shell, monkeypatch):
    """Above ``EXACT_KNN_MAX_SOURCES`` (lowered to 100 in both packages)
    the scan's candidates come from ``grid_knn`` (8 probed 128-member
    bins: all 8 here): found equal, values against the JAX scan to rtol
    1e-5 where both accept in the same element."""
    mesh, pts, field = grid_shell
    pts = pts[N_GRID // 10 - 100:N_GRID // 10 + 500]
    monkeypatch.setattr(jgrid_mod, "EXACT_KNN_MAX_SOURCES", 100)
    monkeypatch.setattr(tgrid, "EXACT_KNN_MAX_SOURCES", 100)
    want = jlocate(pts, mesh.points, 2, fallback="sentinel", engine="xla",
                   strategy="scan")
    tgrid._INDEX_CACHE.clear()
    got = tloc.locate(pts, mesh.points, 2, fallback="sentinel",
                      strategy="scan", device="cpu")
    (index,) = tgrid._INDEX_CACHE.values()
    assert index.members_per_bin == 128
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    assert got.found[100:].all() and not got.found[:100].all()
    ge, we = got.elements.numpy(), np.asarray(want.elements)
    same = got.found.numpy() & (ge == we)
    assert same.mean() > 0.8
    np.testing.assert_allclose(_values(ge, got.weights.numpy(), field)[same],
                               _values(we, want.weights, field)[same],
                               rtol=1e-5)


def test_frozen_lattice_is_prepared_once(grid_shell):
    """A read-only lattice is hashed and prepared once; the prep keeps a
    read-only host copy of the centroids for the grid index."""
    mesh, pts, _ = grid_shell
    nodes = mesh.points.copy()
    nodes.setflags(write=False)
    a = tloc._mesh_prep(nodes, 2, torch.device("cpu"))
    assert tloc._mesh_prep(nodes, 2, torch.device("cpu")) is a
    assert not a.centroids_host.flags.writeable
    np.testing.assert_allclose(a.centroids_host, nodes.mean(axis=1),
                               rtol=1e-14)
    np.testing.assert_array_equal(a.centroids.numpy(), a.centroids_host)
    got = tloc.locate(pts[N_GRID // 10:][:64], nodes, 2, device="cpu")
    assert got.found.all()


def test_polish_attaches_f64_lattice_to_the_cached_prep(grid_shell):
    """One prep per mesh: a polish that comes after a plain locate adds
    the f64 lattice to the cached prep, equal to the one a first call
    with ``want64`` makes, and the f32 lattice is its rounding."""
    mesh = grid_shell[0]
    tloc._PREP_CACHE.clear()
    first = tloc._mesh_prep(mesh.points, 2, "cpu", want64=True)
    tloc._PREP_CACHE.clear()
    a = tloc._mesh_prep(mesh.points, 2, "cpu")
    assert a.nodes64 is None
    b = tloc._mesh_prep(mesh.points, 2, "cpu", want64=True)
    assert b is a and len(tloc._PREP_CACHE) == 1
    assert torch.equal(a.nodes64, first.nodes64)
    assert torch.equal(a.nodes64.float(), a.nodes)
    assert tloc._mesh_prep(mesh.points, 2, "cpu") is a
    assert a.nodes64 is not None


def _near_centroids(mesh, n, seed):
    """``n`` points a fifth of the way from an element's node mean to one
    of its nodes: round 1 finds that element and accepts every row."""
    rng = np.random.default_rng(seed)
    el = rng.integers(0, mesh.nelem, n)
    node = rng.integers(0, mesh.points.shape[1], n)
    cent = mesh.points.mean(axis=1)[el]
    return cent + 0.2 * (mesh.points[el, node] - cent)


def _exact_columns(mesh, pts, k):
    """The caller's candidates: the k nearest node means, by f64 distance."""
    cent = mesh.points.mean(axis=1)
    d2 = ((pts[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


# case -> (source fixture, fallback, use_aabb, chunk); "interior" takes
# only rows round 1 accepts, "candidates" the caller's 12 columns, "grid"
# the grid route
SIZED_CASES = {
    "sentinel": ("shell", "sentinel", False, 1024),
    "snap": ("shell", "snap", False, 262_144),
    "best": ("shell", "best", False, 1024),
    "fixed_ref": ("shell", "fixed_ref", True, 1024),
    "interior": ("shell", "snap", False, 1024),
    "candidates": ("shell", "sentinel", False, 1024),
    "grid": ("grid_shell", "snap", False, 512),
    "grid_fixed_ref": ("grid_shell", "fixed_ref", True, 512),
}


@pytest.mark.parametrize("case", list(SIZED_CASES))
def test_sized_rescue_rounds_equal_the_fixed_buckets(case, request,
                                                     monkeypatch):
    """Rescue rounds sized by round 1's failures give bit for bit what
    the fixed buckets (``_rescue_rows`` patched back to its cap) give: on
    every fallback, with exterior rows that overflow the caps into the
    scan retry, on the grid route and on the caller's candidates.  They
    evaluate no more rows in any round, and a chunk round 1 accepts whole
    skips rounds 2-4: K1 solves each of its rows once."""
    fixture, fallback, use_aabb, chunk = SIZED_CASES[case]
    mesh, pts, _ = request.getfixturevalue(fixture)
    order = mesh.order
    if fixture == "grid_shell":
        request.getfixturevalue("grid_route")
    if case == "interior":
        pts = _near_centroids(mesh, 3000, seed=5)
    candidates = (_exact_columns(mesh, pts, 12) if case == "candidates"
                  else None)
    monkeypatch.setenv("MMT_PROFILE", "1")

    def run():
        tprofile.reset_stages()
        res = tloc.locate(pts, mesh.points, order, fallback=fallback,
                          use_aabb=use_aabb, candidates=candidates,
                          chunk=chunk, device="cpu")
        return res, tprofile.counter_totals()

    got, sized = run()
    with monkeypatch.context() as m:
        m.setattr(tloc, "_rescue_rows", lambda B, n_unaccepted: B)
        want, fixed = run()
    for f in ("elements", "refs", "weights", "found", "accepted"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert got.n_retry == want.n_retry
    n_chunks = -(-len(pts) // chunk)
    rounds = [f"ladder.round{r}.rows" for r in (2, 3, 4)]
    assert all(sized.get(r, 0) <= fixed.get(r, 0) for r in rounds)
    assert sized["k1.rows"] <= fixed["k1.rows"]
    assert "ladder.rescue.skipped" not in fixed
    if case == "interior":
        assert sized["ladder.round1.missed"] == 0 and got.accepted.all()
        assert all(sized.get(r, 0) == 0 for r in rounds)
        assert sized["ladder.rescue.skipped"] == n_chunks
        assert sized["k1.rows"] == len(pts)
        assert fixed["k1.rows"] > 2 * len(pts)
    else:
        assert sized["ladder.round1.missed"] > 0 and got.n_retry > 0
        assert sized.get("ladder.rescue.skipped", 0) < n_chunks
        assert sized["k1.rows"] < fixed["k1.rows"]
