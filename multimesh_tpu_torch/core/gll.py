"""Gauss-Lobatto-Legendre (GLL) reference-element machinery in torch.

Counterpart of the JAX package's ``core/gll.py``.  The node tables
(``gll_nodes``, ``barycentric_weights``, ``lattice_coords``,
``corner_indices``) are numpy and cached; the basis functions work on
torch tensors of any leading shape, on any device, in the dtype of their
input.

Canonical node ordering: flat node ``n`` of a (p+1)^d tensor lattice is
multi-index ``(i_0, ..., i_{d-1})`` in C row-major order (last dimension
fastest), ``n = ((i_0 * (p+1)) + i_1) * (p+1) + i_2`` for d = 3.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def gll_nodes(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (nodes, quadrature weights) of the GLL rule of given order.

    ``order`` is the polynomial order p; there are p+1 nodes in [-1, 1],
    the roots of (1 - x^2) P'_p(x).  float64 numpy arrays.
    """
    if order < 1:
        raise ValueError(f"GLL order must be >= 1, got {order}")
    p = order
    n = p + 1
    if p == 1:
        x = np.array([-1.0, 1.0])
    elif p == 2:
        x = np.array([-1.0, 0.0, 1.0])
    elif p == 3:
        s = np.sqrt(1.0 / 5.0)
        x = np.array([-1.0, -s, s, 1.0])
    elif p == 4:
        s = np.sqrt(3.0 / 7.0)
        x = np.array([-1.0, -s, 0.0, s, 1.0])
    else:
        # Chebyshev-Gauss-Lobatto initial guess, Newton on (1-x^2) P'_p(x).
        x = -np.cos(np.pi * np.arange(n) / p)
        for _ in range(100):
            p0 = np.ones_like(x)
            p1 = x.copy()
            for k in range(2, p + 1):
                p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
            xi = x[1:-1]
            # f = (1-x^2) P'_p = p (P_{p-1} - x P_p); f' = -p(p+1) P_p
            f = p * (p0[1:-1] - xi * p1[1:-1])
            df = -p * (p + 1) * p1[1:-1]
            step = f / df
            x[1:-1] = xi - step
            if np.max(np.abs(step)) < 1e-15:
                break
    # Quadrature weights: w_i = 2 / (p (p+1) P_p(x_i)^2).
    p0 = np.ones_like(x)
    p1 = x.copy()
    for k in range(2, p + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    w = 2.0 / (p * (p + 1) * p1**2)
    return x, w


@functools.lru_cache(maxsize=None)
def barycentric_weights(order: int) -> np.ndarray:
    """w_i = 1 / prod_{j != i} (x_i - x_j) for the GLL nodes (float64)."""
    x, _ = gll_nodes(order)
    diff = x[:, None] - x[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def _diffs(order: int, x: torch.Tensor) -> torch.Tensor:
    nodes = torch.as_tensor(gll_nodes(order)[0], dtype=x.dtype,
                            device=x.device)
    return x[..., None] - nodes


def lagrange_eval(order: int, x: torch.Tensor) -> torch.Tensor:
    """Values of all p+1 Lagrange cardinal polynomials at ``x`` [...]
    -> [..., p+1], in the product form ``l_i(x) = w_i prod_{j != i}
    (x - x_j)`` (branchless, exact at the nodes)."""
    bw = barycentric_weights(order)
    diffs = _diffs(order, x)
    n = order + 1
    cols = []
    for i in range(n):
        prod = torch.ones_like(x)
        for j in range(n):
            if j != i:
                prod = prod * diffs[..., j]
        cols.append(float(bw[i]) * prod)
    return torch.stack(cols, dim=-1)


def lagrange_deriv(order: int, x: torch.Tensor) -> torch.Tensor:
    """d/dx of all p+1 Lagrange cardinal polynomials at ``x`` -> [..., p+1]."""
    bw = barycentric_weights(order)
    diffs = _diffs(order, x)
    n = order + 1
    cols = []
    for i in range(n):
        total = torch.zeros_like(x)
        for k in range(n):
            if k == i:
                continue
            prod = torch.ones_like(x)
            for j in range(n):
                if j != i and j != k:
                    prod = prod * diffs[..., j]
            total = total + prod
        cols.append(float(bw[i]) * total)
    return torch.stack(cols, dim=-1)


def _outer(factors: list[torch.Tensor]) -> torch.Tensor:
    """Row-major tensor product of per-axis [..., p+1] factors ->
    [..., (p+1)^d]."""
    if len(factors) == 3:
        f0, f1, f2 = factors
        out = f0[..., :, None, None] * f1[..., None, :, None] \
            * f2[..., None, None, :]
    elif len(factors) == 2:
        f0, f1 = factors
        out = f0[..., :, None] * f1[..., None, :]
    else:
        raise ValueError(f"dimension must be 2 or 3, got {len(factors)}")
    n = len(factors)
    return out.reshape(*out.shape[:-n], math.prod(out.shape[-n:]))


def tensor_basis(order: int, ref: torch.Tensor) -> torch.Tensor:
    """Tensor-product GLL basis values at reference coordinates
    ``ref`` [..., d] (d in {2, 3}) -> [..., (p+1)^d], canonical order."""
    d = ref.shape[-1]
    return _outer([lagrange_eval(order, ref[..., a]) for a in range(d)])


def tensor_basis_grad(order: int, ref: torch.Tensor) -> torch.Tensor:
    """Gradient of the tensor basis: [..., (p+1)^d, d]."""
    d = ref.shape[-1]
    ls = [lagrange_eval(order, ref[..., a]) for a in range(d)]
    ds = [lagrange_deriv(order, ref[..., a]) for a in range(d)]
    grads = [
        _outer([ds[b] if b == axis else ls[b] for b in range(d)])
        for axis in range(d)
    ]
    return torch.stack(grads, dim=-1)


@functools.lru_cache(maxsize=None)
def lattice_coords(order: int, dim: int) -> np.ndarray:
    """Reference coordinates of every lattice node: [(p+1)^dim, dim], f64."""
    x, _ = gll_nodes(order)
    axes = np.meshgrid(*([x] * dim), indexing="ij")
    return np.stack([a.ravel() for a in axes], axis=-1)


@functools.lru_cache(maxsize=None)
def corner_indices(order: int, dim: int) -> np.ndarray:
    """Flat canonical indices of the 2^dim corner nodes of the lattice
    (in order-1 lattice ordering)."""
    n = order + 1
    rng = (0, order)
    if dim == 3:
        idx = [(i * n + j) * n + k for i in rng for j in rng for k in rng]
    elif dim == 2:
        idx = [i * n + j for i in rng for j in rng]
    else:
        raise ValueError(f"dimension must be 2 or 3, got {dim}")
    return np.asarray(idx, dtype=np.int32)


def infer_order(n_nodes: int, dim: int) -> int:
    """Polynomial order from node count, as the reference infers it
    (reference interpolator.py:667: round(ndata**(1/dim)) - 1)."""
    return int(round(n_nodes ** (1.0 / dim))) - 1
