"""What the layered and point-query pipelines of the port stand on, each
against the JAX package's on the same seeded numpy inputs:

* ``ops.layers`` and ``ops.dedup.unique_points_per_layer`` (host numpy:
  bit-equal);
* ``locate(candidates=)`` and ``locate(centroids=)``, ladder and scan,
  orders 1, 2 and 4, against the JAX ``locate(engine="xla")`` with the
  same arrays: ``found`` identical, elements equal wherever the accepting
  element is unique (a target on a shared face is accepted by both
  neighbours; such rows must then agree in value), refs to 1e-5 (the
  port's f32 Newton against the JAX CPU tier's f64 one), and ``N == 0``;
* ``TransferOperator.build(candidates=, centroids=)`` and the ``weights``
  setter;
* ``engine.get_element_weights`` / ``get_element_weights_layered``;
* ``ops.spherical``: ``map_to_sphere`` on both mesh layouts (bit-equal)
  and ``map_to_ellipse`` (rtol 2e-6, the f32 path's grade).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from multimesh_tpu import engine as jengine  # noqa: E402
from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.ops import TransferOperator as JOp  # noqa: E402
from multimesh_tpu.ops import dedup as jdedup  # noqa: E402
from multimesh_tpu.ops import layers as jlayers  # noqa: E402
from multimesh_tpu.ops import spherical as jsph  # noqa: E402
from multimesh_tpu.search import locate as jlocate  # noqa: E402
from multimesh_tpu_torch import TransferOperator as TOp  # noqa: E402
from multimesh_tpu_torch import engine as tengine  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch.config import R_EARTH_M  # noqa: E402
from multimesh_tpu_torch.config import LocateConfig as TLocateConfig  # noqa: E402
from multimesh_tpu_torch.ops import dedup as tdedup  # noqa: E402
from multimesh_tpu_torch.ops import layers as tlayers  # noqa: E402
from multimesh_tpu_torch.ops import spherical as tsph  # noqa: E402
from multimesh_tpu_torch.search import locate as tloc  # noqa: E402


# -- layers ---------------------------------------------------------------
def _layer_fields():
    layer = np.repeat(np.arange(6, 0, -1), 4).astype(float)  # 6..1
    fluid = (layer <= 2).astype(float)  # the two innermost are the core
    return layer, fluid


@pytest.mark.parametrize("spec", ["all", "crust", "mantle", "core",
                                  "nocore", 3, [5, 2], np.array([6, 1])])
def test_resolve_layers_equals_jax(spec):
    layer, fluid = _layer_fields()
    got = tlayers.resolve_layers(layer, spec, 2, fluid)
    want = jlayers.resolve_layers(layer, spec, 2, fluid)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    masks = tlayers.layer_masks(layer, got[0])
    jmasks = jlayers.layer_masks(layer, want[0])
    assert list(masks) == list(jmasks)
    for k in masks:
        np.testing.assert_array_equal(masks[k], jmasks[k])


def test_resolve_layers_named_groups_and_errors():
    layer, fluid = _layer_fields()
    np.testing.assert_array_equal(
        tlayers.resolve_layers(layer, "crust", 2, fluid)[0], [6, 5])
    np.testing.assert_array_equal(
        tlayers.resolve_layers(layer, "mantle", 2, fluid)[0], [4, 3])
    np.testing.assert_array_equal(
        tlayers.resolve_layers(layer, "core", 2, fluid)[0], [2, 1])
    np.testing.assert_array_equal(
        tlayers.resolve_layers(layer, "nocore", 2, fluid)[0], [6, 5, 4, 3])
    # no fluid: nocore is everything, core cannot be resolved
    ids, masked = tlayers.resolve_layers(layer, "nocore", 2, None)
    assert len(ids) == 6 and not masked
    for bad, kw in ((7, {}), ([9], {}), ("weird", {}), ("crust", {}),
                    ("core", {})):
        with pytest.raises(ValueError):
            tlayers.resolve_layers(layer, bad, None, None, **kw)


@pytest.mark.parametrize("moho", ["2", b"2", np.array(b"2"), None])
def test_mesh_layer_masks_equals_jax(moho):
    layer, fluid = _layer_fields()
    mesh = types.SimpleNamespace(
        get_elemental_fields=lambda: {"layer": layer, "fluid": fluid},
        global_strings={} if moho is None else {"moho_idx": moho})
    spec = "nocore" if moho is None else "mantle"
    masks, ids = tlayers.mesh_layer_masks(mesh, spec)
    jmasks, jids = jlayers.mesh_layer_masks(mesh, spec)
    np.testing.assert_array_equal(ids, jids)
    assert list(masks) == list(jmasks) == [str(int(i)) for i in ids]
    for k in masks:
        np.testing.assert_array_equal(masks[k], jmasks[k])


def test_unique_points_per_layer_equals_jax():
    mesh = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=4, order=2, n_layers=2)
    masks = tlayers.layer_masks(mesh.layer_id, [2, 1])
    got = tdedup.unique_points_per_layer(mesh.points, masks)
    want = jdedup.unique_points_per_layer(mesh.points, masks)
    assert list(got) == list(want) == ["2", "1"]
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])
        flat = mesh.points[masks[k]].reshape(-1, 3)
        np.testing.assert_array_equal(got[k][0][got[k][1]], flat)
        assert len(got[k][0]) < len(flat)


# -- locate(candidates=) / locate(centroids=) -------------------------------
def _case(order):
    """(mesh, targets): interior targets drawn at random (so hardly any
    lies on a face) plus one eighth far outside."""
    rng = np.random.default_rng(20 + order)
    if order == 1:
        mesh = jmt.box_mesh(shape=(5, 5, 4), order=1)
        pts = rng.uniform(0.02, 0.98, size=(1200, 3))
        pts[:150] += 3.0
    else:
        mesh = jmt.shell_mesh(n_lat=4, n_lon=5, n_rad=4, order=order)
        n = 1200
        r = rng.uniform(3.6e6, 6.2e6, n)
        th = rng.uniform(0.55, 1.15, n)
        ph = rng.uniform(0.35, 1.35, n)
        pts = np.stack([r * np.sin(th) * np.cos(ph),
                        r * np.sin(th) * np.sin(ph), r * np.cos(th)], -1)
        pts[:150] *= 2.0
    return mesh, pts


def _knn(centroids, pts, k):
    d2 = ((pts[:, None, :] - centroids[None]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k].astype(np.int32)


def _hold(got, want, mesh, order):
    """found identical; same element on >= 97% of the found rows and refs
    there to 1e-5; a row with another element is one whose point two
    elements accept, so its value must agree to rtol 1e-5."""
    gf, wf = got.found.numpy(), np.asarray(want.found)
    np.testing.assert_array_equal(gf, wf)
    ge, we = got.elements.numpy(), np.asarray(want.elements)
    np.testing.assert_array_equal(ge[~gf], we[~gf])
    same = gf & (ge == we)
    assert same.sum() >= 0.97 * gf.sum() > 0
    np.testing.assert_allclose(got.refs.numpy()[same],
                               np.asarray(want.refs)[same], atol=1e-5)
    field = jmt.element_nodal_field(mesh, "smooth")

    def values(el, w):
        return np.einsum("pn,pn->p", np.asarray(w, np.float64),
                         field[np.maximum(el, 0)])

    np.testing.assert_allclose(values(ge, got.weights.numpy())[gf],
                               values(we, want.weights)[gf], rtol=1e-5)


@pytest.mark.parametrize("strategy", ["ladder", "scan"])
@pytest.mark.parametrize("order", [1, 2, 4])
def test_locate_given_candidates_matches_jax(order, strategy):
    """Six columns, fewer than ``nelem_to_search``: rounds 1-3 (or the
    scan) read them, the ladder's round 4 searches by centroid."""
    mesh, pts = _case(order)
    cand = _knn(mesh.points.mean(axis=1), pts, 6)
    kw = dict(fallback="sentinel", strategy=strategy, candidates=cand)
    want = jlocate(pts, mesh.points, order, engine="xla", **kw)
    got = tloc.locate(pts, mesh.points, order, device="cpu", **kw)
    assert got.elements.dtype == torch.int32
    _hold(got, want, mesh, order)
    assert got.found[150:].all() and not got.found[:150].any()


def test_given_candidates_are_what_is_searched():
    """A single wrong column: the scan can only try it and finds nothing
    inside; the ladder's round 4 still finds the C/128 hardest rows by
    centroid, and no more than its bucket."""
    mesh, pts = _case(2)
    pts = pts[150:662]
    far = np.full((len(pts), 1), 0, np.int32)  # element 0 for every row
    truth = tloc.locate(pts, mesh.points, 2, device="cpu")
    in0 = truth.elements.numpy() == 0
    scan = tloc.locate(pts, mesh.points, 2, device="cpu", strategy="scan",
                       candidates=far)
    sf = scan.found.numpy()
    # element 0 also accepts points just past its faces (accept_tol 1.05)
    assert sf[in0].all() and in0.sum() <= sf.sum() <= in0.sum() + 8
    assert (scan.elements.numpy()[sf] == 0).all()
    lad = tloc.locate(pts, mesh.points, 2, device="cpu", candidates=far)
    extra = int(lad.found.sum()) - int(sf.sum())
    assert 0 < extra <= max(512 // 128, 128)
    # (which rows those are hangs on the junk refs of a far element,
    # so this case is not held against the JAX package row by row)
    assert lad.n_retry > 0  # and the retry scanned the given column again


@pytest.mark.parametrize("fallback", ["snap", "best", "fixed_ref"])
def test_locate_given_candidates_fallbacks_match_jax(fallback):
    """The fallback rows are the same rows, whichever package."""
    mesh, pts = _case(2)
    cand = _knn(mesh.points.mean(axis=1), pts, 8)
    kw = dict(fallback=fallback, candidates=cand,
              use_aabb=fallback == "fixed_ref")
    want = jlocate(pts, mesh.points, 2, engine="xla", strategy="ladder",
                   **kw)
    got = tloc.locate(pts, mesh.points, 2, device="cpu", **kw)
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    ge, we = got.elements.numpy(), np.asarray(want.elements)
    assert (ge == we).mean() >= 0.97
    inside = slice(150, None)
    np.testing.assert_allclose(
        got.refs.numpy()[inside][ge[inside] == we[inside]],
        np.asarray(want.refs)[inside][ge[inside] == we[inside]], atol=1e-5)


@pytest.mark.parametrize("strategy", ["ladder", "scan"])
@pytest.mark.parametrize("order", [1, 2, 4])
def test_locate_given_centroids_matches_jax(order, strategy):
    """AABB centres in place of node means: every search ranks by them
    (on curved shell elements the two differ), the geometry does not."""
    mesh, pts = _case(order)
    cent = 0.5 * (mesh.points.min(axis=1) + mesh.points.max(axis=1))
    kw = dict(fallback="sentinel", strategy=strategy, centroids=cent)
    want = jlocate(pts, mesh.points, order, engine="xla", **kw)
    got = tloc.locate(pts, mesh.points, order, device="cpu", **kw)
    _hold(got, want, mesh, order)


def test_given_centroids_replace_the_search_not_the_geometry():
    """Centroids shifted far away: nothing near a target is searched, so
    nothing is found; the cached prep of the mesh is left as it was."""
    mesh, pts = _case(2)
    cent = mesh.points.mean(axis=1)
    plain = tloc.locate(pts, mesh.points, 2, device="cpu")
    rolled = np.roll(cent, len(cent) // 2, axis=0)
    got = tloc.locate(pts, mesh.points, 2, device="cpu", centroids=rolled,
                      cfg=TLocateConfig(nelem_to_search=2))
    assert got.found.sum() < 0.5 * plain.found.sum()
    again = tloc.locate(pts, mesh.points, 2, device="cpu")
    assert torch.equal(again.elements, plain.elements)
    assert torch.equal(again.refs, plain.refs)
    same = tloc.locate(pts, mesh.points, 2, device="cpu", centroids=cent)
    assert torch.equal(same.elements, plain.elements)


@pytest.mark.parametrize("strategy", ["ladder", "scan"])
@pytest.mark.parametrize("given", ["none", "candidates", "centroids"])
def test_empty_query_set_every_route(strategy, given):
    """A layer with no target points: empty results, as the JAX package."""
    mesh, _ = _case(2)
    kw = {}
    if given == "candidates":
        kw["candidates"] = np.zeros((0, 4), np.int32)
    if given == "centroids":
        kw["centroids"] = mesh.points.mean(axis=1)
    got = tloc.locate(np.zeros((0, 3)), mesh.points, 2, device="cpu",
                      strategy=strategy, **kw)
    want = jlocate(np.zeros((0, 3)), mesh.points, 2, engine="xla",
                   strategy=strategy, **kw)
    assert got.elements.shape == np.asarray(want.elements).shape == (0,)
    assert got.refs.shape == np.asarray(want.refs).shape == (0, 3)
    assert got.weights.shape == np.asarray(want.weights).shape == (0, 27)
    assert got.found.shape == (0,) and got.n_retry == 0
    op = TOp.build(mesh.points, np.zeros((0, 3)), 2, device="cpu", **kw)
    assert op.num_missing == 0
    assert op.apply(np.ones((2, mesh.nelem, 27))).shape == (0, 2)


# -- TransferOperator -----------------------------------------------------
def test_build_passes_candidates_and_centroids():
    mesh, pts = _case(2)
    cent = mesh.points.mean(axis=1)
    cand = _knn(cent, pts, 6)
    a = TOp.build(mesh.points, pts, 2, candidates=cand, device="cpu")
    b = tloc.locate(pts, mesh.points, 2, candidates=cand, device="cpu")
    assert torch.equal(a.elements, b.elements)
    assert torch.equal(a.refs, b.refs)
    c = TOp.build(mesh.points, pts, 2, centroids=cent[::-1].copy(),
                  device="cpu", cfg=TLocateConfig(nelem_to_search=2))
    assert c.num_missing > a.num_missing


def test_weights_setter_applies_the_given_coefficients():
    """An operator given explicit weights has no refs and applies the
    coefficients as stored, like the JAX package's."""
    mesh, pts = _case(2)
    field = np.stack([jmt.element_nodal_field(mesh, "smooth"),
                      jmt.element_nodal_field(mesh, "linear")])
    built = TOp.build(mesh.points, pts, 2, device="cpu")
    w = built.weights.numpy().astype(np.float64)
    op = TOp(elements=built.elements, order=2)
    assert op.refs is None
    op.weights = 2.0 * w  # numpy in, tensor on the operator's device
    assert torch.is_tensor(op.weights) and op.weights.dtype == torch.float64
    jop = JOp(elements=built.elements.numpy(), order=2)
    jop.weights = 2.0 * w
    got = op.apply(field).numpy()
    np.testing.assert_allclose(got, np.asarray(jop.apply(field)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, 2.0 * built.apply(field).numpy(),
                               rtol=2e-6, atol=1e-6)
    assert (got[:150] == 0).all()


# -- engine.get_element_weights[_layered] -----------------------------------
@pytest.mark.parametrize("snap", [False, True])
def test_get_element_weights_matches_jax(snap):
    mesh, pts = _case(2)
    cent = mesh.points.mean(axis=1)
    el, co = tengine.get_element_weights(mesh.points, 2, cent, pts,
                                         snap_to_nearest=snap, device="cpu")
    jel, jco = jengine.get_element_weights(mesh.points, 2, cent, pts,
                                           snap_to_nearest=snap)
    assert isinstance(el, np.ndarray) and el.dtype == np.int32
    assert co.shape == (len(pts), 27)
    np.testing.assert_array_equal(el >= 0, jel >= 0)
    if not snap:
        assert (el[:150] == -1).all() and (co[:150] == 0).all()
    inside = slice(150, None)
    assert (el[inside] == jel[inside]).mean() >= 0.97
    same = np.flatnonzero(el == jel)
    same = same[same >= 150]
    # weights of f32 refs against weights of f64 refs
    np.testing.assert_allclose(co[same], jco[same], atol=2e-5)
    el0, _ = tengine.get_element_weights(mesh.points, 2, None, pts,
                                         snap_to_nearest=snap, device="cpu")
    np.testing.assert_array_equal(el0, el)


def test_get_element_weights_layered_matches_jax():
    """Candidates index the masked element set of each layer."""
    mesh = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=4, order=2, n_layers=2)
    tgt = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=4, order=2, n_layers=2,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
    masks = tlayers.layer_masks(mesh.layer_id, [2, 1])
    tmasks = tlayers.layer_masks(tgt.layer_id, [2, 1])
    coords = tdedup.unique_points_per_layer(tgt.points, tmasks)
    near = {
        l: _knn(mesh.points[masks[l]].mean(axis=1), coords[l][0], 5)
        for l in coords
    }
    src = types.SimpleNamespace(points=mesh.points)
    el, co = tengine.get_element_weights_layered(
        coords, near, src, masks, from_gll_order=2, device="cpu")
    jel, jco = jengine.get_element_weights_layered(
        coords, near, src, masks, from_gll_order=2)
    field = jmt.element_nodal_field(mesh, "smooth")
    for l in coords:
        assert el[l].max() < masks[l].sum()
        np.testing.assert_array_equal(el[l] >= 0, jel[l] >= 0)
        assert (el[l] >= 0).mean() > 0.9
        f_l = field[masks[l]]
        got = np.einsum("pn,pn->p", co[l].astype(np.float64),
                        f_l[np.maximum(el[l], 0)])
        want = np.einsum("pn,pn->p", np.asarray(jco[l], np.float64),
                         f_l[np.maximum(jel[l], 0)])
        np.testing.assert_allclose(got, want, rtol=2e-6)


# -- spherical ------------------------------------------------------------
class _Mesh:
    def __init__(self, mesh, flatten=0.0):
        self.points = mesh.points.copy()
        self.shape_order = mesh.order
        r = np.linalg.norm(self.points, axis=-1)
        self.element_nodal_fields = {"z_node_1D": r / R_EARTH_M}
        if flatten:  # an ellipsoid: z squeezed
            self.points[..., 2] *= 1.0 - flatten


def test_map_to_sphere_both_layouts_equal_jax():
    mesh = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=2)
    a, b = _Mesh(mesh, 0.01), _Mesh(mesh, 0.01)
    tsph.map_to_sphere(a)
    jsph.map_to_sphere(b)
    np.testing.assert_array_equal(a.points, b.points)
    np.testing.assert_allclose(np.linalg.norm(a.points, axis=-1),
                               np.linalg.norm(mesh.points, axis=-1),
                               rtol=1e-12)

    # flat vertex list + connectivity (UnstructuredMesh-like)
    def flat():
        m = types.SimpleNamespace(
            points=mesh.vertices.copy() * np.array([1.0, 1.0, 0.99]),
            connectivity=mesh.connectivity,
            element_nodal_fields={"z_node_1D": np.linalg.norm(
                mesh.vertices[mesh.connectivity], axis=-1) / R_EARTH_M})
        return m

    c, d = flat(), flat()
    tsph.map_to_sphere(c)
    jsph.map_to_sphere(d)
    np.testing.assert_array_equal(c.points, d.points)
    np.testing.assert_allclose(np.linalg.norm(c.points, axis=-1),
                               np.linalg.norm(mesh.vertices, axis=-1),
                               rtol=1e-12)
    c.connectivity = None
    with pytest.raises(ValueError):
        tsph.map_to_sphere(c)
    # the centre stays where it is
    e = types.SimpleNamespace(
        points=np.zeros((1, 2, 3)),
        element_nodal_fields={"z_node_1D": np.ones((1, 2))})
    e.points[0, 1] = [1.0, 0.0, 0.0]
    tsph.map_to_sphere(e)
    np.testing.assert_array_equal(e.points[0, 0], 0.0)
    np.testing.assert_allclose(e.points[0, 1], [R_EARTH_M, 0, 0])


def test_map_to_ellipse_matches_jax_and_restores_the_base():
    base = tmt.shell_mesh(n_lat=4, n_lon=4, n_rad=2, order=2)
    tgt = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=2,
                         r_inner=3.6e6, r_outer=6.3e6,
                         lat_extent=(0.55, 1.15), lon_extent=(0.35, 1.35))
    tb, tt = _Mesh(base, 0.02), _Mesh(tgt)
    jb, jt = _Mesh(base, 0.02), _Mesh(tgt)
    before = tb.points.copy()
    tsph.map_to_ellipse(tb, tt, device="cpu")
    jsph.map_to_ellipse(jb, jt)
    np.testing.assert_array_equal(tb.points, before)  # base restored
    np.testing.assert_allclose(tt.points, jt.points, rtol=2e-6)
    assert not np.allclose(tt.points, tgt.points, rtol=1e-4)  # stretched
    # a failing transfer leaves both meshes as they were
    tt2 = _Mesh(tgt)
    with pytest.raises(ValueError):
        tsph.map_to_ellipse(tb, tt2, device="meta")
    np.testing.assert_array_equal(tb.points, before)
    np.testing.assert_array_equal(tt2.points, tgt.points)


def test_map_to_ellipse_carries_the_wgs84_ellipticity():
    """``testing.elliptic_mesh``'s base (radius 1 + eps(theta) times the
    sphere's, WGS84's flattening) onto a spherical order-4 target through
    both packages: the port's target against the JAX package's (the f32
    path's grade), its radius ratio against 1 + eps at every node (an f32
    apply of a field near 1: ~4e-7 here), the base restored bit for bit."""
    base = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=4)
    tgt = tmt.shell_mesh(n_lat=3, n_lon=3, n_rad=2, order=4, r_inner=3.7e6,
                         r_outer=6.2e6, lat_extent=(0.58, 1.12),
                         lon_extent=(0.38, 1.32))
    tb, tt = tmt.elliptic_mesh(base), tmt.elliptic_mesh(tgt, 0.0)
    jb, jt = tmt.elliptic_mesh(base), tmt.elliptic_mesh(tgt, 0.0)
    before = tb.points.copy()
    np.testing.assert_array_equal(tt.points, tgt.points)
    tsph.map_to_ellipse(tb, tt, device="cpu")
    jsph.map_to_ellipse(jb, jt)
    np.testing.assert_array_equal(tb.points, before)
    np.testing.assert_allclose(tt.points, jt.points, rtol=2e-6)
    ratio = (np.linalg.norm(tt.points, axis=-1)
             / (R_EARTH_M * tt.element_nodal_fields["z_node_1D"]))
    want = 1.0 + tmt.ellipticity(tgt.points)
    assert np.ptp(want) > 1.5e-3  # the target spans half of f
    np.testing.assert_allclose(ratio, want, rtol=1e-6)
