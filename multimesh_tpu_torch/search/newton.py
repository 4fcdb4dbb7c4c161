"""K1: the batched Newton inverse map over (point, element) rows.

Counterpart of the JAX package's ``search/pallas_newton.py``
(``newton_refs_rows`` for the ladder, ``newton_refs`` for the scan and
for its trilinear prefilter, which runs the kernel at order 1 on the
element corners).  The kernel is ``csrc/newton_rows.cu``;
``newton_refs_rows_ref`` is its plain PyTorch twin,
``core.shape._newton_iterations`` in f32 on the gathered unit-frame
lattice rows.

Both take the same arguments:

* ``points`` [M, d] f64 physical coordinates, ``ids`` [M] int32 element
  ids;
* per element: ``ctr`` [E, d] f64 centre, ``inv_scale`` [E] f64 inverse
  scale, ``nodes`` [E, n*d] f32 unit-frame lattice ((x - ctr) * inv_scale
  flattened as ``m * d + a``);

and return ``(refs [M, d] f32, res [M] f32)``: the reference coordinates
after ``iters`` steps from zero, and the max-abs residual at that iterate
in the unit-element frame.

``newton_rows`` picks by the tensors' device: CPU tensors run the plain
twin, CUDA tensors launch the kernel, any other device raises.
"""
from __future__ import annotations

import torch

from .. import _build
from ..core import shape

ORDERS = (1, 2, 4)  # the orders the kernel is compiled for


def newton_refs_rows_ref(points, ids, ctr, inv_scale, nodes, order: int,
                         dim: int, iters: int, clamp: float):
    """Plain PyTorch twin of the kernel (any device)."""
    ids = ids.long()
    p_c = ((points - ctr[ids]) * inv_scale[ids, None]).to(torch.float32)
    rows = nodes[ids].view(-1, (order + 1) ** dim, dim)
    return shape._newton_iterations(
        order, rows, p_c, torch.zeros_like(p_c), iters, clamp)


def _check_args(points, ids, ctr, inv_scale, nodes, order, dim):
    M = points.shape[0]
    E = ctr.shape[0]
    n_feat = (order + 1) ** dim * dim
    expect = {
        "points": (points, torch.float64, (M, dim)),
        "ids": (ids, torch.int32, (M,)),
        "ctr": (ctr, torch.float64, (E, dim)),
        "inv_scale": (inv_scale, torch.float64, (E,)),
        "nodes": (nodes, torch.float32, (E, n_feat)),
    }
    for name, (t, dtype, shp) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shp:
            raise ValueError(
                f"newton_rows: {name} must be {dtype} {shp}, got "
                f"{t.dtype} {tuple(t.shape)}")
        if t.device != points.device:
            raise ValueError(
                f"newton_rows: {name} is on {t.device}, points on "
                f"{points.device}")
        if not t.is_contiguous():
            raise ValueError(f"newton_rows: {name} must be contiguous")
    if dim not in (2, 3):
        raise ValueError(f"newton_rows: dim must be 2 or 3, got {dim}")


def newton_rows(points, ids, ctr, inv_scale, nodes, order: int, dim: int,
                iters: int, clamp: float):
    """Newton refs and residuals for M (point, element) rows (see module
    docstring); CUDA tensors launch K1, CPU tensors run the twin."""
    _check_args(points, ids, ctr, inv_scale, nodes, order, dim)
    device = points.device
    if device.type == "cpu":
        return newton_refs_rows_ref(points, ids, ctr, inv_scale, nodes,
                                    order, dim, iters, clamp)
    if device.type != "cuda":
        raise ValueError(f"newton_rows: unsupported device {device}")
    if order not in ORDERS:
        raise NotImplementedError(
            f"newton_rows: the kernel is built for orders {ORDERS}, "
            f"got {order}")
    M = points.shape[0]
    refs = torch.empty((M, dim), dtype=torch.float32, device=device)
    res = torch.empty((M,), dtype=torch.float32, device=device)
    if M == 0:
        return refs, res
    lib = _build.library()
    err = lib.mmt_newton_rows(
        points.data_ptr(), ids.data_ptr(), ctr.data_ptr(),
        inv_scale.data_ptr(), nodes.data_ptr(), M, ctr.shape[0], order,
        dim, iters, clamp, refs.data_ptr(), res.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, err, "newton_rows")
    newton_rows.launches += 1
    if order == 1:
        newton_rows.launches_order1 += 1
    return refs, res


newton_rows.launches = 0  # kernel launches in this process
newton_rows.launches_order1 = 0  # of which at order 1 (the prefilter's)
