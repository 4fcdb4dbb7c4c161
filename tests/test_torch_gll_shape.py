"""GLL basis and shape maps of the PyTorch port against the JAX package.

The same numpy inputs (from a seed) go through ``multimesh_tpu.core`` and
``multimesh_tpu_torch.core``; both run in float64 on the CPU, so the
tolerances are float64 round-off of the product-form basis.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from multimesh_tpu import testing as jmt  # noqa: E402
from multimesh_tpu.config import LocateConfig  # noqa: E402
from multimesh_tpu.core import gll as jgll, shape as jshape  # noqa: E402
from multimesh_tpu_torch import testing as tmt  # noqa: E402
from multimesh_tpu_torch.core import gll as tgll, shape as tshape  # noqa: E402

ORDER_DIM = [(o, d) for o in (1, 2, 3, 4) for d in (2, 3)]


def _refs(dim, n=200, seed=0, spread=1.2):
    return np.random.default_rng(seed).uniform(-spread, spread, (n, dim))


@pytest.mark.parametrize("order,dim", ORDER_DIM)
def test_tensor_basis_matches_jax(order, dim):
    """Basis values at random refs: same product form in f64 on both
    sides, so agreement is to a few ulp (atol 1e-13 on O(1) values)."""
    ref = _refs(dim, seed=order * 10 + dim)
    want = np.asarray(jgll.tensor_basis(order, jnp.asarray(ref)))
    got = tgll.tensor_basis(order, torch.from_numpy(ref)).numpy()
    assert got.shape == want.shape == (ref.shape[0], (order + 1) ** dim)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-13)
    # partition of unity: the basis reproduces constants exactly
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-12)


@pytest.mark.parametrize("order,dim", ORDER_DIM)
def test_tensor_basis_grad_matches_jax(order, dim):
    """Gradients (derivative product form) in f64: atol 1e-12 covers the
    larger magnitudes of the order-4 derivatives at |ref| = 1.2."""
    ref = _refs(dim, seed=100 + order * 10 + dim)
    want = np.asarray(jgll.tensor_basis_grad(order, jnp.asarray(ref)))
    got = tgll.tensor_basis_grad(order, torch.from_numpy(ref)).numpy()
    assert got.shape == want.shape == (ref.shape[0], (order + 1) ** dim, dim)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5, 6, 7])
def test_node_tables_match_jax(order):
    """The numpy node tables are copies: bitwise equal."""
    for a, b in zip(tgll.gll_nodes(order), jgll.gll_nodes(order)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgll.barycentric_weights(order),
                                  jgll.barycentric_weights(order))
    for dim in (2, 3):
        np.testing.assert_array_equal(tgll.lattice_coords(order, dim),
                                      jgll.lattice_coords(order, dim))
        np.testing.assert_array_equal(tgll.corner_indices(order, dim),
                                      jgll.corner_indices(order, dim))


def _mesh(order, dim):
    shape = (3, 3, 3) if dim == 3 else (4, 4)
    return jmt.box_mesh(shape=shape, order=order, warp=0.15)


@pytest.mark.parametrize("order,dim", ORDER_DIM)
def test_inverse_map_matches_jax(order, dim):
    """inverse_map on warped (curved) elements, all-f64 schedule: the
    converged refs agree to 1e-10 (both Newton runs stop at the f64
    fixed point) and the converged masks agree exactly."""
    mesh = _mesh(order, dim)
    rng = np.random.default_rng(order * 10 + dim)
    n = 300
    ids = rng.integers(0, mesh.nelem, n)
    nodes = mesh.points[ids]
    # points inside each element (forward map of random refs), plus a
    # few well outside it that must report non-acceptance
    ref_true = rng.uniform(-0.95, 0.95, (n, dim))
    ref_true[: n // 10] *= 1.6
    pts = np.array(jshape.forward_map(order, jnp.asarray(nodes),
                                      jnp.asarray(ref_true)))
    want_ref, want_conv = jshape.inverse_map(jnp.asarray(nodes),
                                             jnp.asarray(pts), order=order)
    got_ref, got_conv = tshape.inverse_map(torch.from_numpy(nodes),
                                           torch.from_numpy(pts), order)
    np.testing.assert_array_equal(got_conv.numpy(), np.asarray(want_conv))
    conv = got_conv.numpy()
    assert conv.mean() > 0.85
    np.testing.assert_allclose(got_ref.numpy()[conv],
                               np.asarray(want_ref)[conv], atol=1e-10)
    np.testing.assert_allclose(got_ref.numpy()[conv], ref_true[conv],
                               atol=1e-9)


@pytest.mark.parametrize("order,dim", [(2, 3), (4, 3), (4, 2)])
def test_inverse_map_mixed_precision_matches_jax(order, dim):
    """f32 bulk iterations + f64 polish (Precision.MIXED's schedule):
    the polish lands both at the f64 fixed point, 1e-10."""
    mesh = _mesh(order, dim)
    rng = np.random.default_rng(7 + order + dim)
    ids = rng.integers(0, mesh.nelem, 200)
    nodes = mesh.points[ids]
    ref_true = rng.uniform(-0.9, 0.9, (200, dim))
    pts = np.array(jshape.forward_map(order, jnp.asarray(nodes),
                                      jnp.asarray(ref_true)))
    cfg = LocateConfig()
    want_ref, want_conv = jshape.inverse_map(
        jnp.asarray(nodes), jnp.asarray(pts), order=order, cfg=cfg,
        dtype=jnp.float32)
    got_ref, got_conv = tshape.inverse_map(
        torch.from_numpy(nodes), torch.from_numpy(pts), order, cfg,
        dtype=torch.float32)
    np.testing.assert_array_equal(got_conv.numpy(), np.asarray(want_conv))
    assert got_conv.numpy().all()
    np.testing.assert_allclose(got_ref.numpy(), np.asarray(want_ref),
                               atol=1e-10)


@pytest.mark.parametrize("order,dim", [(1, 3), (4, 3), (2, 2)])
def test_forward_map_and_jacobian_match_jax(order, dim):
    """forward_map / shape_jacobian in f64: sums over the lattice in
    another order than einsum, so rtol 1e-12 (atol 1e-9 m on the
    Earth-scale coordinates of the shell, 1e-12 on the unit box)."""
    if dim == 3:
        mesh = jmt.shell_mesh(n_lat=2, n_lon=2, n_rad=2, order=order)
        atol = 1e-6
    else:
        mesh = _mesh(order, dim)
        atol = 1e-12
    ref = _refs(dim, n=mesh.nelem, seed=3)
    nodes = mesh.points
    want_x = np.asarray(jshape.forward_map(order, jnp.asarray(nodes),
                                           jnp.asarray(ref)))
    want_j = np.asarray(jshape.shape_jacobian(order, jnp.asarray(nodes),
                                              jnp.asarray(ref)))
    got_x = tshape.forward_map(order, torch.from_numpy(nodes),
                               torch.from_numpy(ref)).numpy()
    got_j = tshape.shape_jacobian(order, torch.from_numpy(nodes),
                                  torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(got_x, want_x, rtol=1e-12, atol=atol)
    np.testing.assert_allclose(got_j, want_j, rtol=1e-12, atol=atol)


def test_degenerate_element_gives_no_nan():
    """A collapsed element (det == 0 everywhere) steps by zero, as the JAX
    _solve_small does: finite refs, never converged."""
    nodes = np.zeros((1, 27, 3))
    pts = np.ones((1, 3))
    ref, conv = tshape.inverse_map(torch.from_numpy(nodes),
                                   torch.from_numpy(pts), 2)
    assert torch.isfinite(ref).all() and not conv.any()


@pytest.mark.parametrize("kind", ["box", "box_warp", "shell"])
def test_fixtures_match_jax(kind):
    """The numpy fixtures are copies: bitwise-equal meshes and fields."""
    if kind == "shell":
        a = tmt.shell_mesh(n_lat=3, n_lon=4, n_rad=2, order=4, n_layers=2)
        b = jmt.shell_mesh(n_lat=3, n_lon=4, n_rad=2, order=4, n_layers=2)
    else:
        warp = 0.15 if kind == "box_warp" else 0.0
        a = tmt.box_mesh(shape=(2, 3, 2), order=2, warp=warp)
        b = jmt.box_mesh(shape=(2, 3, 2), order=2, warp=warp)
    for name in ("points", "connectivity", "vertices", "layer_id"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for fk in ("smooth", "linear"):
        np.testing.assert_array_equal(tmt.element_nodal_field(a, fk),
                                      jmt.element_nodal_field(b, fk))


@pytest.mark.parametrize("dim", [2, 3])
def test_trilinear_inverse_map_matches_jax(dim):
    """The order-1 wrapper: the same refs (1e-10) and masks as the JAX
    package's on warped corner elements, points inside and outside."""
    mesh = _mesh(1, dim)
    rng = np.random.default_rng(40 + dim)
    ids = rng.integers(0, mesh.nelem, 200)
    nodes = mesh.points[ids]
    ref_true = rng.uniform(-0.95, 0.95, (200, dim))
    ref_true[:20] *= 1.6
    pts = np.array(jshape.forward_map(1, jnp.asarray(nodes),
                                      jnp.asarray(ref_true)))
    want_ref, want_conv = jshape.trilinear_inverse_map(jnp.asarray(nodes),
                                                       jnp.asarray(pts))
    got_ref, got_conv = tshape.trilinear_inverse_map(
        torch.from_numpy(nodes), torch.from_numpy(pts))
    np.testing.assert_array_equal(got_conv.numpy(), np.asarray(want_conv))
    conv = got_conv.numpy()
    assert conv.all()
    np.testing.assert_allclose(got_ref.numpy(), np.asarray(want_ref),
                               atol=1e-10)
    np.testing.assert_allclose(got_ref.numpy(), ref_true, atol=1e-9)


@pytest.mark.parametrize("kind", ["smooth", "linear"])
@pytest.mark.parametrize("dim", [2, 3])
def test_smooth_field_torch_matches_smooth_field(kind, dim):
    """The tensor field against the numpy one (and the JAX package's
    ``smooth_field_jnp``) at Earth scale, 1e-15 relative, f64 on the
    CPU; f32 input stays f32."""
    pts = np.random.default_rng(dim).uniform(-6.4e6, 6.4e6, (2000, dim))
    got = tmt.smooth_field_torch(torch.from_numpy(pts), kind).numpy()
    want = tmt.smooth_field(pts, kind, scale=6.371e6)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    np.testing.assert_allclose(
        got, np.asarray(jmt.smooth_field_jnp(jnp.asarray(pts), kind)),
        rtol=1e-15, atol=0)
    f32 = tmt.smooth_field_torch(torch.from_numpy(pts).float(), kind)
    assert f32.dtype == torch.float32
    with pytest.raises(ValueError):
        tmt.smooth_field_torch(torch.from_numpy(pts), "rough")


def test_infer_order_matches_jax():
    for order in range(1, 8):
        for dim in (2, 3):
            n = (order + 1) ** dim
            assert tgll.infer_order(n, dim) == jgll.infer_order(n, dim) \
                == order
