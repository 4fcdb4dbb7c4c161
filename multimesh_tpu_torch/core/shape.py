"""Element shape mappings and the batched Newton inverse map in torch.

Counterpart of the JAX package's ``core/shape.py``: a fixed, branchless Newton
schedule batched over [points (x candidates)] on coordinates centred and
scaled per element, with convergence reported as a mask.  It is also the
plain PyTorch twin of the Newton kernel (``search.newton``), which runs
``_newton_iterations`` in f32 on the unit-frame lattice rows.

The contractions over lattice nodes are written as multiply + sum rather
than ``einsum``: on a GPU a float32 matmul may run in TF32 when a caller
enabled it globally, and the twin must stay float32 throughout.
"""
from __future__ import annotations

import torch

from ..config import DEFAULT_LOCATE, LocateConfig
from . import gll


def forward_map(order: int, elem_nodes: torch.Tensor,
                ref: torch.Tensor) -> torch.Tensor:
    """x(ref) = sum_n N_n(ref) x_n; elem_nodes [..., n, d], ref [..., d]
    -> [..., d]."""
    basis = gll.tensor_basis(order, ref.to(elem_nodes.dtype))
    return (basis[..., :, None] * elem_nodes).sum(dim=-2)


def shape_jacobian(order: int, elem_nodes: torch.Tensor,
                   ref: torch.Tensor) -> torch.Tensor:
    """J[a][b] = d x_a / d ref_b, shape [..., d, d]."""
    grad = gll.tensor_basis_grad(order, ref.to(elem_nodes.dtype))
    # grad [..., n, d_ref], nodes [..., n, d_x] -> J [..., d_x, d_ref]
    return (elem_nodes[..., :, :, None] * grad[..., :, None, :]).sum(dim=-3)


def _solve_small(A: torch.Tensor, b: torch.Tensor):
    """Solve A x = b for batched 2x2 / 3x3 via adjugate; returns (x, det)."""
    d = A.shape[-1]
    if d == 3:
        a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
        a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
        a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
        c00 = a11 * a22 - a12 * a21
        c01 = a02 * a21 - a01 * a22
        c02 = a01 * a12 - a02 * a11
        c10 = a12 * a20 - a10 * a22
        c11 = a00 * a22 - a02 * a20
        c12 = a02 * a10 - a00 * a12
        c20 = a10 * a21 - a11 * a20
        c21 = a01 * a20 - a00 * a21
        c22 = a00 * a11 - a01 * a10
        det = a00 * c00 + a01 * c10 + a02 * c20
        inv_det = torch.where(
            det == 0, 0.0, 1.0 / torch.where(det == 0, 1.0, det))
        b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
        x0 = (c00 * b0 + c01 * b1 + c02 * b2) * inv_det
        x1 = (c10 * b0 + c11 * b1 + c12 * b2) * inv_det
        x2 = (c20 * b0 + c21 * b1 + c22 * b2) * inv_det
        return torch.stack([x0, x1, x2], dim=-1), det
    if d == 2:
        a00, a01 = A[..., 0, 0], A[..., 0, 1]
        a10, a11 = A[..., 1, 0], A[..., 1, 1]
        det = a00 * a11 - a01 * a10
        inv_det = torch.where(
            det == 0, 0.0, 1.0 / torch.where(det == 0, 1.0, det))
        b0, b1 = b[..., 0], b[..., 1]
        x0 = (a11 * b0 - a01 * b1) * inv_det
        x1 = (a00 * b1 - a10 * b0) * inv_det
        return torch.stack([x0, x1], dim=-1), det
    raise ValueError(f"dimension must be 2 or 3, got {d}")


def element_center_scale(elem_nodes: torch.Tensor):
    """Per-element centering shift and isotropic scale from the node AABB:
    elem_nodes [..., n, d] -> (center [..., d], scale [..., 1]); scale is
    half the largest extent, floored for degenerate elements."""
    lo = elem_nodes.amin(dim=-2)
    hi = elem_nodes.amax(dim=-2)
    center = 0.5 * (lo + hi)
    scale = 0.5 * (hi - lo).amax(dim=-1, keepdim=True)
    scale = scale.clamp_min(torch.finfo(elem_nodes.dtype).tiny * 1e10)
    return center, scale


def _newton_iterations(order: int, nodes_c: torch.Tensor,
                       point_c: torch.Tensor, ref0: torch.Tensor,
                       n_iters: int, clamp: float):
    """``n_iters`` Newton steps on centred, unit-scale coordinates.

    nodes_c [..., n, d], point_c [..., d], ref0 [..., d].  Returns (ref,
    max-abs residual at the final iterate).  No tolerance enters the
    loop: the caller judges convergence from the residual.  A singular
    Jacobian (det == 0) gives a zero step, a non-finite step is zeroed,
    and iterates are clamped to +/- clamp.
    """
    ref = ref0
    for _ in range(n_iters):
        r = point_c - forward_map(order, nodes_c, ref)
        jac = shape_jacobian(order, nodes_c, ref)
        step, _ = _solve_small(jac, r)
        step = torch.where(torch.isfinite(step), step, 0.0)
        ref = torch.clamp(ref + step, -clamp, clamp)
    x = forward_map(order, nodes_c, ref)
    res = (point_c - x).abs().amax(dim=-1)
    return ref, res


def inverse_map(elem_nodes: torch.Tensor, point: torch.Tensor, order: int,
                cfg: LocateConfig = DEFAULT_LOCATE, dtype=None, ref0=None):
    """Batched inverse of the shape map: find ref with x(ref) = point.

    elem_nodes [..., n_nodes, d] physical node coordinates (canonical
    lattice order), point [..., d].  Returns (ref [..., d], converged
    [...]).  ``cfg.newton_iters`` bulk iterations run at ``dtype`` (or
    the input dtype) on centred coordinates, then ``cfg.polish_iters`` at
    the input dtype; converged means residual < newton_rtol (floored at
    64 ulp of the input dtype) in the unit-element frame.
    """
    d = point.shape[-1]
    n_nodes = elem_nodes.shape[-2]
    if (order + 1) ** d != n_nodes:
        raise ValueError(
            f"element has {n_nodes} nodes, expected {(order + 1) ** d} "
            f"for order {order} in {d}D"
        )
    acc_dt = elem_nodes.dtype
    bulk_dt = dtype if dtype is not None else acc_dt
    center, scale = element_center_scale(elem_nodes)
    nodes_c = (elem_nodes - center[..., None, :]) / scale[..., None, :]
    point_c = (point.to(acc_dt) - center) / scale
    ref0 = torch.zeros_like(point_c) if ref0 is None else ref0.to(acc_dt)
    ref, _ = _newton_iterations(
        order, nodes_c.to(bulk_dt), point_c.to(bulk_dt), ref0.to(bulk_dt),
        cfg.newton_iters, cfg.newton_clamp,
    )
    ref = ref.to(acc_dt)
    if cfg.polish_iters > 0:
        ref, res = _newton_iterations(
            order, nodes_c, point_c, ref, cfg.polish_iters, cfg.newton_clamp,
        )
    else:
        res = (point_c - forward_map(order, nodes_c, ref)).abs().amax(-1)
    tol = max(cfg.newton_rtol, float(torch.finfo(acc_dt).eps) * 64)
    return ref, res < tol


def trilinear_inverse_map(elem_nodes: torch.Tensor, point: torch.Tensor,
                          cfg: LocateConfig = DEFAULT_LOCATE, dtype=None):
    """Inverse map for 2^d-corner (order-1) elements; thin wrapper."""
    return inverse_map(elem_nodes, point, order=1, cfg=cfg, dtype=dtype)
