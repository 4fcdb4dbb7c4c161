"""The plain reference against values worked out by hand at a tiny size,
and the frozen copies of the inputs' makers against their origins."""
import math

import numpy as np
import pytest
import torch

from benchmark import meshes, reference


def test_gll_nodes_of_order_4_by_hand():
    s = math.sqrt(3.0 / 7.0)
    np.testing.assert_allclose(meshes.gll_nodes(4), [-1, -s, 0, s, 1],
                               rtol=0, atol=1e-15)


@pytest.mark.parametrize("order", [1, 2, 4, 6])
def test_basis_is_cardinal_at_the_nodes(order):
    x = torch.as_tensor(meshes.gll_nodes(order), dtype=torch.float64)
    grid = torch.stack(torch.meshgrid(x, x, x, indexing="ij"), -1)
    grid = grid.reshape(-1, 3)
    np.testing.assert_allclose(reference.basis(order, grid).numpy(),
                               np.eye((order + 1) ** 3), atol=1e-12)


def test_basis_gradient_by_hand_at_order_1():
    # order 1: l0 = (1 - x) / 2, l1 = (1 + x) / 2; node (1, 0, 1) is
    # l1(a) l0(b) l1(c), whose gradient is (l0(b) l1(c), -l1(a) l1(c), l1(a) l0(b)) / 2
    a, b, c = 0.3, -0.2, 0.5
    g = reference.basis_grad(1, torch.tensor([[a, b, c]],
                                             dtype=torch.float64))[0]
    l0 = lambda x: (1 - x) / 2  # noqa: E731
    l1 = lambda x: (1 + x) / 2  # noqa: E731
    node = (1 * 2 + 0) * 2 + 1
    expect = [l0(b) * l1(c) / 2, -l1(a) * l1(c) / 2, l1(a) * l0(b) / 2]
    np.testing.assert_allclose(g[node].numpy(), expect, rtol=1e-14)


def _affine_element(order):
    """One element: the box [1, 3] x [-2, 0] x [10, 14] (x = 2 + xi,
    y = -1 + xi, z = 12 + 2 xi)."""
    x = torch.as_tensor(meshes.gll_nodes(order), dtype=torch.float64)
    g = torch.stack(torch.meshgrid(x, x, x, indexing="ij"), -1).reshape(-1, 3)
    return torch.stack([2 + g[:, 0], -1 + g[:, 1], 12 + 2 * g[:, 2]], -1)


def test_locate_and_interpolate_by_hand():
    order = 4
    elem = _affine_element(order)
    # a second element far away, whose centroid is nearer to nothing here
    lattice = torch.stack([elem, elem + 100.0])
    q = torch.tensor([[2.5, -1.25, 13.0], [1.0, 0.0, 10.0]],
                     dtype=torch.float64)
    e, xi, found = reference.locate(lattice, q, order)
    assert e.tolist() == [0, 0] and found.all()
    np.testing.assert_allclose(xi.numpy(), [[0.5, -0.25, 0.5],
                                            [-1.0, 1.0, -1.0]], atol=1e-12)
    # x^4 + x y z - z^2 / 4 is of degree <= 4 in each coordinate: exact
    f = lambda p: p[..., 0] ** 4 + p[..., 0] * p[..., 1] * p[..., 2] \
        - p[..., 2] ** 2 / 4  # noqa: E731
    values = f(lattice)[None]  # [1, E, n]
    got = reference.interpolate(values, e, xi, order)[:, 0]
    np.testing.assert_allclose(got.numpy(), f(q).numpy(), rtol=1e-12)


def test_a_target_outside_every_element_is_not_found():
    lattice = _affine_element(2)[None]
    e, xi, found = reference.locate(
        lattice, torch.tensor([[9.0, 0.0, 12.0]], dtype=torch.float64), 2)
    assert not found.any()
    assert xi.abs().max() <= 1.0


def test_control_precision_reads_far_above_f32_rounding():
    order = 4
    lattice = meshes.shell_lattice(3, 3, 3, order)
    values = meshes.smooth_field(lattice)[None]
    gen = torch.Generator().manual_seed(3)
    law = {"r": [3.6e6, 6.3e6], "theta": [0.55, 1.15], "phi": [0.35, 1.35]}
    q = meshes.shell_targets(300, law, gen, "cpu")
    e, xi, found = reference.locate(lattice, q, order)
    assert found.all()
    exact = reference.interpolate(values, e, xi, order)
    rel = lambda dt: float(((reference.interpolate(  # noqa: E731
        values, e, xi, order, dtype=dt) - exact).abs() / exact).max())
    assert rel(torch.float32) < 2e-6
    assert rel(torch.bfloat16) > 1e-3


def test_shell_lattice_matches_testing_shell_mesh():
    from multimesh_tpu_torch import testing

    for args in ((3, 4, 2), (2, 2, 3, 4, 3.7e6, 6.2e6, (0.58, 1.12),
                              (0.38, 1.32)), (2, 3, 2, 2)):
        m = testing.shell_mesh(*args)
        np.testing.assert_allclose(meshes.shell_lattice(*args).numpy(),
                                   m.points, rtol=1e-14, atol=0)


def test_smooth_field_matches_testing():
    from multimesh_tpu_torch import testing

    pts = meshes.shell_lattice(2, 2, 2)
    np.testing.assert_allclose(
        meshes.smooth_field(pts).numpy(),
        testing.smooth_field(pts.numpy(), "smooth"), rtol=1e-15)
    np.testing.assert_allclose(
        meshes.smooth_field(pts).numpy(),
        testing.smooth_field_torch(pts).numpy(), rtol=1e-15)


def test_target_law_matches_bench_py():
    """The same ranges as bench.py's draw (the streams differ: torch's
    generator draws here); the empirical ranges of both agree."""
    import bench

    law = {"r": [3.6e6, 6.3e6], "theta": [0.55, 1.15], "phi": [0.35, 1.35]}
    gen = torch.Generator().manual_seed(0)
    ours = meshes.shell_targets(50000, law, gen, "cpu").numpy()
    theirs = bench._target_points(50000)

    def sph(p):
        r = np.linalg.norm(p, axis=-1)
        return np.stack([r, np.arccos(p[:, 2] / r),
                         np.arctan2(p[:, 1], p[:, 0])], -1)

    a, b = sph(ours), sph(theirs)
    np.testing.assert_allclose(a.min(0), b.min(0), rtol=2e-3)
    np.testing.assert_allclose(a.max(0), b.max(0), rtol=2e-3)
    np.testing.assert_allclose(a.mean(0), b.mean(0), rtol=1e-2)
