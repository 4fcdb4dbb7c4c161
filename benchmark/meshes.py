"""The benchmark's inputs: GLL lattices of spherical-shell chunks, the
analytic fields on them and random targets inside them.

Frozen copies, rewritten in PyTorch so that a 1.5 GB lattice is made on
the card in milliseconds; a later change to the program cannot move them.
Origins:

* ``gll_nodes``: ``multimesh_tpu_torch/core/gll.py:21-66`` (orders 1-4 in
  closed form, higher orders by Newton on (1 - x^2) P'_p);
* ``shell_lattice``: ``multimesh_tpu_torch/testing.py:72-172``
  (``box_mesh`` without warp, then ``shell_mesh``'s map to Cartesian
  coordinates), canonical node order: flat node ``(i * n + j) * n + k``
  of lattice indices (i, j, k) along (r, theta, phi);
* ``shell_layer_ids``: ``multimesh_tpu_torch/testing.py:169-171``
  (``shell_mesh``'s ``layer_id``);
* ``smooth_field``: ``multimesh_tpu_torch/testing.py:175-225``
  (``smooth_field_torch``, kind "smooth", Earth-scale normalisation);
* ``shell_targets``: ``bench.py:48-55`` (r, theta, phi uniform in a box
  of the shell), drawn with a ``torch.Generator`` on the targets' device.

A box element's trilinear map is evaluated per axis, ``lo (1 - x) / 2 +
hi (1 + x) / 2``: a node shared by two elements gets the same bits from
both, so the lattice's duplicate nodes are exact duplicates, as in the
origin.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

R_EARTH = 6.371e6


@functools.lru_cache(maxsize=None)
def gll_nodes(order: int) -> np.ndarray:
    """The order + 1 Gauss-Lobatto-Legendre nodes in [-1, 1] (f64)."""
    if order < 1:
        raise ValueError(f"GLL order must be >= 1, got {order}")
    p = order
    if p <= 4:
        s3, s5 = math.sqrt(3.0 / 7.0), math.sqrt(1.0 / 5.0)
        return np.array({1: [-1.0, 1.0], 2: [-1.0, 0.0, 1.0],
                         3: [-1.0, -s5, s5, 1.0],
                         4: [-1.0, -s3, 0.0, s3, 1.0]}[p])
    x = -np.cos(np.pi * np.arange(p + 1) / p)
    for _ in range(100):
        p0, p1 = np.ones_like(x), x.copy()
        for k in range(2, p + 1):
            p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
        xi = x[1:-1]
        step = (p * (p0[1:-1] - xi * p1[1:-1])) / (-p * (p + 1) * p1[1:-1])
        x[1:-1] = xi - step
        if np.max(np.abs(step)) < 1e-15:
            break
    return x


def shell_lattice(n_lat: int, n_lon: int, n_rad: int, order: int = 4,
                  r_inner: float = 3.48e6, r_outer: float = R_EARTH,
                  lat_extent=(0.5, 1.2), lon_extent=(0.3, 1.4),
                  device="cpu") -> torch.Tensor:
    """[n_rad * n_lat * n_lon, (order + 1)^3, 3] f64 Cartesian GLL nodes
    of a spherical-shell chunk: elements in C order over (r, theta, phi),
    nodes on exact spheres, as ``testing.shell_mesh(n_lat, n_lon, n_rad,
    order, ...)``."""
    x = torch.as_tensor(gll_nodes(order), dtype=torch.float64,
                        device=device)
    lo_w, hi_w = (1.0 - x) / 2.0, (1.0 + x) / 2.0

    def axis(lo, hi, n):
        # np.linspace's vertices, then each element's nodes [n, order+1]
        v = torch.as_tensor(np.linspace(lo, hi, n + 1), dtype=torch.float64,
                            device=device)
        return v[:-1, None] * lo_w + v[1:, None] * hi_w

    r = axis(r_inner, r_outer, n_rad)
    th = axis(*lat_extent, n_lat)
    ph = axis(*lon_extent, n_lon)
    n = order + 1
    r = r[:, None, None, :, None, None]
    th = th[None, :, None, None, :, None]
    ph = ph[None, None, :, None, None, :]
    shape = (n_rad, n_lat, n_lon, n, n, n)
    sin_th = torch.sin(th)
    pts = torch.stack([
        (r * sin_th * torch.cos(ph)).expand(shape),
        (r * sin_th * torch.sin(ph)).expand(shape),
        (r * torch.cos(th)).expand(shape),
    ], dim=-1)
    return pts.reshape(n_rad * n_lat * n_lon, n ** 3, 3)


def shell_layer_ids(n_lat: int, n_lon: int, n_rad: int,
                    n_layers: int = 1, device="cpu") -> torch.Tensor:
    """[n_rad * n_lat * n_lon] int64 layer ids of ``shell_lattice``'s
    elements: its ``n_rad`` radial bands split into ``n_layers`` groups,
    1 innermost, as ``testing.shell_mesh(..., n_layers=n_layers)`` writes
    them into its ``layer`` field."""
    band = torch.arange(n_rad, dtype=torch.int64, device=device)
    layer = band * n_layers // n_rad + 1
    return layer.repeat_interleave(n_lat * n_lon)


def smooth_field(points: torch.Tensor, scale: float = R_EARTH):
    """The analytic "smooth" field at ``points`` [..., 3] -> [...]; it lies
    in [3.2, 5.8]."""
    u = points / scale
    return (4.5 + torch.sin(3.0 * u[..., 0]) * torch.cos(2.0 * u[..., 1] + 0.5)
            + 0.3 * torch.sin(2.0 * u[..., 2] + 1.0))


def shell_targets(n: int, law: dict, generator: torch.Generator,
                  device) -> torch.Tensor:
    """``n`` targets [n, 3] f64, (r, theta, phi) uniform over the ranges
    ``law["r"]``, ``law["theta"]``, ``law["phi"]``."""
    def uniform(lo, hi):
        u = torch.rand(n, dtype=torch.float64, generator=generator,
                       device=device)
        return lo + (hi - lo) * u

    r = uniform(*law["r"])
    th = uniform(*law["theta"])
    ph = uniform(*law["phi"])
    return torch.stack([r * torch.sin(th) * torch.cos(ph),
                        r * torch.sin(th) * torch.sin(ph),
                        r * torch.cos(th)], dim=-1)


def rotate_z(points: torch.Tensor, angle: float) -> torch.Tensor:
    """``points`` [..., 3] rotated by ``angle`` radians about the polar
    axis (identical inputs give identical outputs, so exact duplicates
    stay exact)."""
    c, s = math.cos(angle), math.sin(angle)
    x, y, z = points.unbind(-1)
    return torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)
