"""Plain reference of upstream MultiMesh's regular-grid export
(``extract_regular_grid``): the nodal values of an order-N GLL mesh
sampled onto a regular lat/lon/depth grid, with 0.0 at every grid point
that no element holds.

Upstream (``multi_mesh/api.py:600-642``,
``multi_mesh/components/interpolator.py:1600-1646``, and the zeros of
``interpolate_to_points``, ``interpolator.py:931-977``), as the port
documents it (``engine.extract_regular_grid``, ``search/locate.py``):

* the grid: ``lat``, ``lon`` and ``depth`` each a ``numpy.linspace`` of
  (first, last, count), its points in (depth, lat, lon) order, each at
  radius ``R_EARTH`` - depth, colatitude 90 - lat and longitude lon on a
  geocentric sphere;
* for each point the ``nelem_to_search`` elements whose centroids (the
  means of their nodes) lie nearest, in distance order;
* the inverse of each candidate's order-N GLL map by Newton's method; the
  first candidate in distance order whose reference coordinates all lie
  within ``ACCEPT`` = 1.05 holds the point;
* the value there is the element's order-N Lagrange interpolant of its
  nodal values; a point that no candidate holds reads 0.0 (the sentinel
  fallback: no snapping).

Departures from upstream:

* upstream hands the grid's sampling to the ``salvus`` mesh utilities,
  which are not public; this follows the semantics the port documents
  (the geocentric sphere of ``utils.latlondepth_to_xyz``, then
  ``interpolate_to_points``);
* the candidates come from brute force (``torch.cdist`` + ``topk``) over
  the element centroids in place of a KD-tree; the two give the same list
  up to the order of exactly equidistant centroids;
* Newton runs a fixed ``NEWTON_STEPS`` steps in float64 from the centre
  of each element's own frame (its box centre, scaled by half its
  largest extent); a candidate whose residual stays above ``CONV_TOL``
  of that frame is passed over; upstream iterates with its own stopping
  rule;
* candidate columns are tried one after another and only for the points
  no earlier column accepted: the same choice as trying every column;
* the values are float64 (the port applies float32 coefficients), and
  the grid's data come back as one array [P, depth, lat, lon] in place of
  upstream's xarray dataset.

Node order is the tensor-product order of a GLL lattice: node
``(i * n + j) * n + k`` sits at the GLL nodes (x_i, x_j, x_k) of the
element's reference coordinates.  Only ``torch`` and ``numpy`` are
imported; the work runs in float64 on the device of ``device`` (any).
"""
from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

R_EARTH = 6_371_000.0
ACCEPT = 1.05
NEWTON_STEPS = 25
CONV_TOL = 1e-9
# entries of one [rows, elements] distance block (1 GiB of float64)
_DIST_ENTRIES = 2**27


@contextlib.contextmanager
def _exact_matmul():
    """float32 products in float32, not TF32, while open (on a card)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _tensor(a) -> torch.Tensor:
    """``a`` as a tensor; a host array is copied (it may be read-only)."""
    return (torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray)
            else torch.as_tensor(a))


@functools.lru_cache(maxsize=None)
def gll_nodes(order: int) -> tuple:
    """The order + 1 Gauss-Lobatto-Legendre nodes in [-1, 1]: the roots of
    (1 - x^2) P'_order(x), by Newton's method from the Chebyshev-Lobatto
    points."""
    if order < 1:
        raise ValueError(f"GLL order must be >= 1, got {order}")
    x = -np.cos(np.pi * np.arange(order + 1) / order)
    for _ in range(100):
        p0, p1 = np.ones_like(x), x.copy()
        for k in range(2, order + 1):
            p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
        inner = x[1:-1]
        # (1 - x^2) P' = p (P_{p-1} - x P_p); its derivative is -p (p + 1) P_p
        step = (order * (p0[1:-1] - inner * p1[1:-1])
                / (-order * (order + 1) * p1[1:-1]))
        x[1:-1] = inner - step
        if not step.size or np.max(np.abs(step)) < 1e-16:
            break
    return tuple(float(v) for v in x)


def lagrange(order: int, x: torch.Tensor, deriv: bool = False):
    """The order + 1 Lagrange cardinal polynomials on the GLL nodes at
    ``x`` [...] -> [..., order + 1] (or their derivatives), in the dtype
    of ``x``."""
    nodes = gll_nodes(order)
    cols = []
    for i, xi in enumerate(nodes):
        others = [xj for j, xj in enumerate(nodes) if j != i]
        denom = math.prod(xi - xj for xj in others)
        if not deriv:
            prod = torch.ones_like(x)
            for xj in others:
                prod = prod * (x - xj)
            cols.append(prod / denom)
            continue
        total = torch.zeros_like(x)
        for skip in range(len(others)):
            prod = torch.ones_like(x)
            for m, xj in enumerate(others):
                if m != skip:
                    prod = prod * (x - xj)
            total = total + prod
        cols.append(total / denom)
    return torch.stack(cols, dim=-1)


def basis(order: int, xi: torch.Tensor) -> torch.Tensor:
    """Tensor-product basis at ``xi`` [..., 3] -> [..., (order + 1)^3]."""
    l0, l1, l2 = (lagrange(order, xi[..., a]) for a in range(3))
    out = (l0[..., :, None, None] * l1[..., None, :, None]
           * l2[..., None, None, :])
    return out.flatten(-3)


def basis_grad(order: int, xi: torch.Tensor) -> torch.Tensor:
    """d basis / d xi: [..., (order + 1)^3, 3]."""
    ls = [lagrange(order, xi[..., a]) for a in range(3)]
    ds = [lagrange(order, xi[..., a], deriv=True) for a in range(3)]
    cols = []
    for axis in range(3):
        f = [ds[b] if b == axis else ls[b] for b in range(3)]
        out = (f[0][..., :, None, None] * f[1][..., None, :, None]
               * f[2][..., None, None, :])
        cols.append(out.flatten(-3))
    return torch.stack(cols, dim=-1)


def newton(nodes: torch.Tensor, q: torch.Tensor, order: int):
    """Reference coordinates [M, 3] of the points ``q`` [M, 3] in the
    elements ``nodes`` [M, n, 3] (float64), and whether Newton converged
    [M]."""
    lo, hi = nodes.amin(dim=1), nodes.amax(dim=1)
    ctr = (lo + hi) / 2.0
    scale = ((hi - lo).amax(dim=-1) / 2.0).clamp_min(1e-30)[:, None]
    x = (nodes - ctr[:, None, :]) / scale[:, None]
    p = (q - ctr) / scale
    xi = torch.zeros_like(p)
    for _ in range(NEWTON_STEPS):
        r = (basis(order, xi)[..., None] * x).sum(dim=-2) - p
        jac = torch.einsum("mna,mnb->mab", x, basis_grad(order, xi))
        step = torch.linalg.solve_ex(jac, r[..., None])[0][..., 0]
        xi = (xi - step).nan_to_num(4.0, 4.0, -4.0).clamp(-4.0, 4.0)
    r = (basis(order, xi)[..., None] * x).sum(dim=-2) - p
    return xi, r.abs().amax(dim=-1) < CONV_TOL


def _order_of(n: int) -> int:
    order = round(n ** (1.0 / 3.0)) - 1
    if order < 1 or (order + 1) ** 3 != n:
        raise ValueError(f"{n} nodes an element is no 3-D GLL lattice")
    return order


def grid_axes(lat_extent, lon_extent, depth_extent):
    """(lat, lon, depth) f64 host arrays of a grid whose extents are each
    (first, last, count)."""
    return tuple(np.linspace(float(a), float(b), int(n))
                 for a, b, n in (lat_extent, lon_extent, depth_extent))


def grid_points(lat, lon, depth) -> np.ndarray:
    """[len(depth) * len(lat) * len(lon), 3] f64 Cartesian points of the
    grid, depth slowest and longitude fastest."""
    dd, la, lo = np.meshgrid(np.asarray(depth, np.float64),
                             np.asarray(lat, np.float64),
                             np.asarray(lon, np.float64), indexing="ij")
    r = R_EARTH - dd.ravel()
    th, ph = np.deg2rad(90.0 - la.ravel()), np.deg2rad(lo.ravel())
    return np.stack([r * np.sin(th) * np.cos(ph),
                     r * np.sin(th) * np.sin(ph), r * np.cos(th)], axis=-1)


def locate(lattice, targets, nelem_to_search: int = 20, device=None,
           block: int = 16384):
    """(element [S] long, xi [S, 3] f64) of each target [S, 3] in the
    elements ``lattice`` [E, n, 3], ``block`` targets at a time, on
    ``device`` (default: the device ``lattice`` is on, or the CPU for host
    arrays).  Where no candidate holds a target, element is -1 and xi
    is 0."""
    lat = _tensor(lattice)
    device = torch.device(device) if device is not None else lat.device
    lat = lat.to(device=device, dtype=torch.float64)
    order = _order_of(lat.shape[1])
    pts = _tensor(targets).to(device=device, dtype=torch.float64)
    pts = pts.reshape(-1, 3)
    k = min(int(nelem_to_search), lat.shape[0])
    centroids = lat.mean(dim=1)
    rows_per_dist = max(1, min(block, _DIST_ENTRIES // lat.shape[0]))
    element = torch.full((pts.shape[0],), -1, dtype=torch.long,
                         device=device)
    xi = torch.zeros_like(pts)
    with _exact_matmul():
        for s in range(0, pts.shape[0], block):
            q = pts[s:s + block]
            cand = torch.cat([
                torch.cdist(q[t:t + rows_per_dist], centroids).topk(
                    k, dim=1, largest=False, sorted=True).indices
                for t in range(0, q.shape[0], rows_per_dist)])  # [B, k]
            elem, x_b = element[s:s + block], xi[s:s + block]
            for c in range(k):
                rows = (elem < 0).nonzero()[:, 0]
                if not rows.numel():
                    break
                e = cand[rows, c]
                x, conv = newton(lat[e], q[rows], order)
                ok = conv & (x.abs().amax(dim=-1) <= ACCEPT)
                elem[rows[ok]], x_b[rows[ok]] = e[ok], x[ok]
    return element, xi


def interpolate(values, element: torch.Tensor, xi: torch.Tensor,
                dtype: torch.dtype = torch.float64,
                block: int = 16384) -> torch.Tensor:
    """[S, P] float64: the nodal ``values`` [P, E, n] at each target's
    (``element``, ``xi``), computed in ``dtype``, ``block`` targets at a
    time; 0.0 where ``element`` is -1."""
    v = _tensor(values).to(device=xi.device)
    order = _order_of(v.shape[-1])
    out = torch.zeros((xi.shape[0], v.shape[0]), dtype=torch.float64,
                      device=xi.device)
    for s in range(0, xi.shape[0], block):
        e = element[s:s + block]
        w = basis(order, xi[s:s + block].to(dtype))  # [B, n]
        vals = v[:, e.clamp(min=0), :].to(dtype)  # [P, B, n]
        got = (vals * w[None]).sum(dim=-1).T.to(torch.float64)
        out[s:s + block] = torch.where(e[:, None] >= 0, got, 0.0)
    return out


def extract_regular_grid(lattice, values, lat_extent, lon_extent,
                         depth_extent, nelem_to_search: int = 20,
                         device=None, block: int = 16384):
    """(lat, lon, depth, data): the grid's axes (host arrays) and the
    source's nodal ``values`` [P, E, n] on the elements ``lattice``
    [E, n, 3] sampled at every grid point, ``data`` [P, len(depth),
    len(lat), len(lon)] float64 on the device the work ran on, 0.0 where
    no element holds the point."""
    lat, lon, depth = grid_axes(lat_extent, lon_extent, depth_extent)
    element, xi = locate(lattice, grid_points(lat, lon, depth),
                         nelem_to_search, device, block)
    vals = interpolate(values, element, xi, block=block)
    return lat, lon, depth, vals.T.reshape(-1, len(depth), len(lat),
                                           len(lon))
