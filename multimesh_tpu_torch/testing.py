"""Synthetic mesh fixtures for tests and the on-card smoke run.

The JAX package's ``testing.py``: structured hexahedral GLL meshes over
boxes and spherical shells, and smooth analytic fields that interpolation
must reproduce (numpy, and ``smooth_field_torch`` on tensors).  The same
arguments give the same arrays as the JAX package's fixtures.
"""
from __future__ import annotations

import dataclasses
import os
import types

import numpy as np

from .core import gll


@dataclasses.dataclass
class StructuredMesh:
    """A structured hex mesh with GLL lattice nodes per element.

    points:        [nelem, n_gll, dim]  node coordinates (canonical order)
    connectivity:  [nelem, 2^dim]       corner-vertex indices into `vertices`
    vertices:      [nvert, dim]         unique corner vertices
    order:         polynomial order of the per-element lattice
    layer_id:      [nelem]              integer layer of each element
    """

    points: np.ndarray
    connectivity: np.ndarray
    vertices: np.ndarray
    order: int
    layer_id: np.ndarray

    @property
    def nelem(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[2]

    @property
    def n_gll(self) -> int:
        return self.points.shape[1]

    def centroids(self) -> np.ndarray:
        return self.points.mean(axis=1)


def _structured_corners(shape, dim):
    """Vertex grid + per-element corner connectivity for a structured grid
    (canonical corner order, matching gll.corner_indices)."""
    nv = [s + 1 for s in shape]
    vert_idx = np.arange(int(np.prod(nv))).reshape(nv)
    grids = np.meshgrid(*[np.arange(s) for s in shape], indexing="ij")
    if dim == 3:
        i, j, k = grids
        cols = [
            vert_idx[i + a, j + b, k + c_].ravel()
            for a in (0, 1) for b in (0, 1) for c_ in (0, 1)
        ]
    else:
        i, j = grids
        cols = [
            vert_idx[i + a, j + b].ravel()
            for a in (0, 1) for b in (0, 1)
        ]
    return np.stack(cols, axis=-1).astype(np.int64)


def box_mesh(
    shape=(4, 4, 4),
    order: int = 4,
    extent=None,
    warp: float = 0.0,
    seed: int = 0,
) -> StructuredMesh:
    """Structured box mesh of hex elements with GLL lattices.

    ``warp`` > 0 applies a smooth sinusoidal deformation to interior
    vertices (elements become non-affine but stay valid for warp <~ 0.2).
    """
    dim = len(shape)
    if extent is None:
        extent = [(0.0, 1.0)] * dim
    axes = [np.linspace(lo, hi, s + 1) for (lo, hi), s in zip(extent, shape)]
    grids = np.meshgrid(*axes, indexing="ij")
    vertices = np.stack([g.ravel() for g in grids], axis=-1)

    conn = _structured_corners(shape, dim)

    # per-element GLL lattice through the (possibly warped) geometry map,
    # evaluated at the physical lattice positions so warped elements are
    # genuinely curved
    lat = gll.lattice_coords(order, dim)  # [n, dim] in [-1,1]
    corners = vertices[conn]  # [E, 2^dim, dim]
    corner_ref = gll.lattice_coords(1, dim)  # [2^dim, dim]
    tri_basis = np.prod(
        1.0 + lat[:, None, :] * corner_ref[None, :, :], axis=-1
    ) / (2.0**dim)  # [n, 2^dim]
    points = np.einsum("nc,ecd->end", tri_basis, corners)

    if warp > 0.0:
        spans = np.array([hi - lo for lo, hi in extent])
        lo = np.array([lo for lo, hi in extent])
        u = (points - lo) / spans  # in [0,1]^d
        bump = np.sin(np.pi * u)  # vanishes on every face
        disp = np.zeros_like(points)
        for d in range(dim):
            # the extra bump[..., d] factor keeps the displacement zero on
            # the faces, so the warped mesh still covers the nominal box
            disp[..., d] = (
                spans[d]
                * warp**2
                * bump[..., d]
                * bump[..., (d + 1) % dim]
                * bump[..., (d + 2) % dim if dim == 3 else (d + 1) % dim]
                * 0.5
            )
        points = points + disp
        ci = gll.corner_indices(order, dim)
        flat_conn = conn.ravel()
        vertices = vertices.copy()
        vertices[flat_conn] = points[:, ci, :].reshape(-1, dim)

    layer_id = np.zeros(conn.shape[0], dtype=np.int64)
    return StructuredMesh(points, conn, vertices, order, layer_id)


def shell_mesh(
    n_lat: int = 6,
    n_lon: int = 8,
    n_rad: int = 3,
    order: int = 4,
    r_inner: float = 3.48e6,
    r_outer: float = 6.371e6,
    lat_extent=(0.5, 1.2),
    lon_extent=(0.3, 1.4),
    n_layers: int = 1,
) -> StructuredMesh:
    """Curved spherical-shell mesh chunk at Earth scale.

    Element GLL nodes lie on exact spherical surfaces, as in global
    seismic (Salvus) meshes; radial element bands get descending layer
    ids (outermost layer has the largest id).
    """
    shape = (n_rad, n_lat, n_lon)
    mesh = box_mesh(
        shape=shape,
        order=order,
        extent=[(r_inner, r_outer), lat_extent, lon_extent],
    )

    def to_cart(p):
        r, theta, phi = p[..., 0], p[..., 1], p[..., 2]
        return np.stack(
            [
                r * np.sin(theta) * np.cos(phi),
                r * np.sin(theta) * np.sin(phi),
                r * np.cos(theta),
            ],
            axis=-1,
        )

    points = to_cart(mesh.points)
    vertices = to_cart(mesh.vertices)
    band = (np.arange(mesh.nelem) // (n_lat * n_lon)).astype(np.int64)
    group = (band * n_layers) // n_rad
    layer_id = group + 1
    return StructuredMesh(points, mesh.connectivity, vertices, mesh.order,
                          layer_id)


def smooth_field(points: np.ndarray, kind: str = "smooth",
                 scale: float | None = None) -> np.ndarray:
    """Analytic scalar fields for transfer-accuracy tests.

    ``points`` [..., dim] -> [...].  "smooth" is infinitely differentiable
    (interpolation error decays spectrally); "linear" must be reproduced to
    round-off by any order >= 1.  ``scale`` normalizes coordinates and MUST
    be consistent between mesh-sampled and truth evaluations; by default
    small-coordinate inputs use 1.0 and Earth-scale inputs use R_EARTH.
    """
    if scale is None:
        scale = 1.0 if float(np.max(np.abs(points))) <= 100.0 else 6.371e6
    u = points / scale
    if kind == "linear":
        out = 2.0 + u[..., 0] + 0.5 * u[..., 1]
        if points.shape[-1] == 3:
            out = out - 0.25 * u[..., 2]
        return out
    if kind == "smooth":
        out = (
            4.5
            + np.sin(3.0 * u[..., 0])
            * np.cos(2.0 * u[..., 1] + 0.5)
        )
        if points.shape[-1] == 3:
            out = out + 0.3 * np.sin(2.0 * u[..., 2] + 1.0)
        return out
    raise ValueError(kind)



def smooth_field_torch(points, kind: str = "smooth", scale: float = 6.371e6):
    """``smooth_field`` on a tensor of any device and dtype (the JAX
    package's ``smooth_field_jnp``): for accuracy checks on the card at
    sizes where evaluating the field on the host would dominate;
    Earth-scale normalization by default."""
    import torch

    u = points / scale
    if kind == "linear":
        out = 2.0 + u[..., 0] + 0.5 * u[..., 1]
        if points.shape[-1] == 3:
            out = out - 0.25 * u[..., 2]
        return out
    if kind == "smooth":
        out = (
            4.5
            + torch.sin(3.0 * u[..., 0]) * torch.cos(2.0 * u[..., 1] + 0.5)
        )
        if points.shape[-1] == 3:
            out = out + 0.3 * torch.sin(2.0 * u[..., 2] + 1.0)
        return out
    raise ValueError(kind)

def element_nodal_field(mesh: StructuredMesh, kind: str = "smooth"):
    """Sample a smooth_field at every GLL node: [nelem, n_gll]."""
    return smooth_field(mesh.points, kind=kind)


def salvus_fixture_fields(
    mesh: StructuredMesh,
    parameters=("VP", "VS", "RHO"),
    fluid: np.ndarray | None = None,
    field_kind: str = "smooth",
):
    """(nodal, elemental) fields of ``write_salvus_fixture``'s file, as
    name -> array dicts: each parameter a scaled copy of the same
    analytic field (so transfers of several parameters are
    distinguishable), then ``z_node_1D``; elemental ``fluid`` and
    ``layer``."""
    base = element_nodal_field(mesh, field_kind)
    nodal = {
        p: base * (1.0 + 0.1 * i) for i, p in enumerate(parameters)
    }
    r = np.linalg.norm(mesh.points, axis=-1)
    nodal["z_node_1D"] = r / 6.371e6  # spherical 1D radius fraction
    if fluid is None:
        fluid = np.zeros(mesh.nelem)
    elemental = {
        "fluid": np.asarray(fluid, np.float64),
        "layer": mesh.layer_id.astype(np.float64),
    }
    return nodal, elemental


def write_salvus_fixture(
    filename,
    mesh: StructuredMesh,
    parameters=("VP", "VS", "RHO"),
    fluid: np.ndarray | None = None,
    global_strings: dict | None = None,
    field_kind: str = "smooth",
):
    """Write a StructuredMesh as a Salvus-format HDF5 file with the
    analytic fields of ``salvus_fixture_fields``; returns the nodal ones.
    Needs ``h5py``."""
    from .io import salvus as sio

    nodal, elemental = salvus_fixture_fields(mesh, parameters, fluid,
                                             field_kind)
    sio.write_salvus_mesh(
        filename, mesh.points, nodal, elemental, global_strings or {}
    )
    return nodal


def write_exodus_fixture(
    filename, mesh: StructuredMesh, parameters=("VP", "VS", "RHO"),
    field_kind: str = "smooth",
):
    """Write the corner-vertex skeleton of a StructuredMesh as an Exodus II
    file with analytic nodal fields."""
    from .io import exodus as eio

    base = smooth_field(mesh.vertices, field_kind)
    nodal = {p: base * (1.0 + 0.1 * i) for i, p in enumerate(parameters)}
    elemental = {"something_elemental": np.arange(mesh.nelem, dtype=float)}
    eio.write_exodus(
        filename, mesh.vertices, mesh.connectivity, nodal, elemental,
        canonical_order=True,
    )
    return nodal


# WGS84's flattening: an elliptic stretch of a spherical fixture
WGS84_FLATTENING = 1.0 / 298.257


def ellipticity(points: np.ndarray,
                flattening: float = WGS84_FLATTENING) -> np.ndarray:
    """eps(theta) = f (1/3 - cos^2 theta) at ``points`` [..., 3], theta
    the colatitude: to first order in f, the ellipsoid of flattening f
    with the sphere's mean radius lies at r = r_sphere (1 + eps)."""
    r = np.linalg.norm(points, axis=-1)
    cos = np.divide(points[..., 2], r, out=np.zeros_like(r), where=r > 0)
    return flattening * (1.0 / 3.0 - cos**2)


def elliptic_mesh(mesh: StructuredMesh,
                  flattening: float = WGS84_FLATTENING):
    """A live mesh object for ``ops.spherical``: a copy of ``mesh``'s
    points stretched radially by 1 + ``ellipticity``, ``shape_order``,
    and ``z_node_1D`` the unstretched radius over 6.371e6 (spherical).
    ``flattening=0`` gives the spherical mesh itself, on a writable copy
    of its lattice."""
    r = np.linalg.norm(mesh.points, axis=-1)
    stretch = 1.0 + ellipticity(mesh.points, flattening)
    return types.SimpleNamespace(
        points=mesh.points * stretch[..., None], shape_order=mesh.order,
        element_nodal_fields={"z_node_1D": r / 6.371e6})


def shell_targets(n_points: int, seed: int = 0) -> np.ndarray:
    """``n_points`` random targets [n, 3] inside the default shell_mesh
    chunk (the JAX package's bench.py draw, from ``seed``)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(3.6e6, 6.3e6, n_points)
    th = rng.uniform(0.55, 1.15, n_points)
    ph = rng.uniform(0.35, 1.35, n_points)
    return np.stack(
        [r * np.sin(th) * np.cos(ph), r * np.sin(th) * np.sin(ph),
         r * np.cos(th)], -1)


# the edges of the dedup's grouping (``ops/dedup.py``), one input each
DEDUP_EDGE_CASES = ("signed_zero", "nan", "one_row", "all_equal",
                    "none_shared", "d2")


def dedup_edge_points(case: str) -> np.ndarray:
    """An input [N, d] f64 at one edge of the dedup's grouping
    (``DEDUP_EDGE_CASES``): the first-appearance grouping
    (``dedup_first``) on the CPU and on the card and the host path are
    held to each other on the same ones."""
    if case == "signed_zero":  # -0.0 == +0.0: one group, the first bits
        return np.array([[-0.0, 1.0, 0.0], [0.0, 1.0, -0.0], [2.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0], [-0.0, 1.0, -0.0]])
    if case == "nan":  # a row with a NaN equals no row, itself included
        return np.array([[np.nan, 1.0, 2.0], [1.0, 1.0, 2.0],
                         [np.nan, 1.0, 2.0], [1.0, 1.0, 2.0],
                         [1.0, np.nan, 2.0], [1.0, 1.0, np.nan]])
    if case == "one_row":
        return np.array([[3.0, -1.5, 2.25]])
    if case == "all_equal":
        return np.full((300, 3), 1.25)
    if case == "none_shared":
        return np.random.default_rng(3).normal(size=(400, 3))
    if case == "d2":
        return np.random.default_rng(4).integers(0, 5, (300, 2)) / 2.0
    raise ValueError(case)


def reverse_stored_operator(src_dir, dst_dir) -> None:
    """Copy the compact stored operator at ``src_dir`` (``TransferOperator
    .save``) to ``dst_dir`` with its unique rows in reverse order and its
    recon renumbered to match: the same operator in an order no dedup
    gives, for the expansion's tests."""
    os.makedirs(dst_dir)
    for name in os.listdir(src_dir):
        a = np.load(os.path.join(src_dir, name))
        if name == "recon.npy":
            a = a.max() - a
        elif name != "meta.npy":
            a = a[::-1]
        np.save(os.path.join(dst_dir, name), np.ascontiguousarray(a))
