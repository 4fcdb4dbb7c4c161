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
twin, CUDA tensors launch the kernel, any other device raises.  On the
card the rows are first grouped by element (``group_rows``), so a block
of the kernel shares a few element lattices; the kernel writes each
row's result back at its own position.
"""
from __future__ import annotations

import torch

from .. import _build
from ..core import shape
from ..utils_profile import count

ORDERS = (1, 2, 3, 4, 5, 6, 7)  # the orders the kernel is compiled for
_MAX_ROWS = 2**31 - 1  # int32 row indices


def newton_refs_rows_ref(points, ids, ctr, inv_scale, nodes, order: int,
                         dim: int, iters: int, clamp: float):
    """Plain PyTorch twin of the kernel (any device)."""
    ids = ids.long()
    p_c = ((points - ctr[ids]) * inv_scale[ids, None]).to(torch.float32)
    rows = nodes[ids].view(-1, (order + 1) ** dim, dim)
    return shape._newton_iterations(
        order, rows, p_c, torch.zeros_like(p_c), iters, clamp)


def group_rows_ref(ids, E: int):
    """Plain twin of the grouping pre-pass: the permutation [M] int32 that
    orders the rows by element id, rows of one element in row order, the
    rows whose id is out of range (< 0 or >= E) last."""
    key = torch.where((ids >= 0) & (ids < E), ids, E)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def group_rows(ids, E: int):
    """The rows' grouping permutation [M] int32: ids non-decreasing under
    it, out-of-range ids last.  CPU tensors run the twin; CUDA tensors
    launch the counting sort of ``csrc/newton_rows.cu``, which leaves
    the rows of one element in no particular order.  It is the first pass
    of K1, K4 and K5 on the card, so it caps their rows at 2**31 - 1."""
    device = ids.device
    if device.type == "cpu":
        return group_rows_ref(ids, E)
    if device.type != "cuda":
        raise ValueError(f"group_rows: unsupported device {device}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("group_rows: ids must be contiguous 1-D int32")
    M = ids.shape[0]
    if M > _MAX_ROWS or E >= _MAX_ROWS:
        raise ValueError(f"group_rows: {M} rows of {E} elements, more than "
                         f"the int32 permutation holds")
    lib = _build.library()
    perm = torch.empty((M,), dtype=torch.int32, device=device)
    # scratch: E + 1 bin counters, then one total per tile of the scan
    n_tiles = -(-(E + 1) // lib.mmt_group_scan_tile())
    counts = torch.empty((E + 1 + n_tiles,), dtype=torch.int32,
                         device=device)
    err = lib.mmt_group_rows(ids.data_ptr(), M, E, counts.data_ptr(),
                             counts[E + 1:].data_ptr(), n_tiles,
                             perm.data_ptr(),
                             torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, err, "group_rows")
    return perm


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
    docstring); CUDA tensors launch K1 on the rows grouped by element,
    CPU tensors run the twin."""
    _check_args(points, ids, ctr, inv_scale, nodes, order, dim)
    count("k1.rows", points.shape[0])
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
    if points.shape[0] == 0:
        return (torch.empty((0, dim), dtype=torch.float32, device=device),
                torch.empty((0,), dtype=torch.float32, device=device))
    return _newton_kernel(group_rows(ids, ctr.shape[0]), points, ids, ctr,
                          inv_scale, nodes, order, dim, iters, clamp)


def _newton_kernel(perm, points, ids, ctr, inv_scale, nodes, order: int,
                   dim: int, iters: int, clamp: float):
    """Launch K1 over the rows in the order ``perm`` [M] int32 gives (any
    permutation gives the same bits; ``group_rows``' grouping makes it
    fast) on checked CUDA tensors."""
    M, E, device = points.shape[0], ctr.shape[0], points.device
    refs = torch.empty((M, dim), dtype=torch.float32, device=device)
    res = torch.empty((M,), dtype=torch.float32, device=device)
    lib = _build.library()
    err = lib.mmt_newton_rows(
        points.data_ptr(), ids.data_ptr(), perm.data_ptr(), ctr.data_ptr(),
        inv_scale.data_ptr(), nodes.data_ptr(), M, E, order, dim, iters,
        clamp, refs.data_ptr(), res.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, err, "newton_rows")
    newton_rows.launches += 1
    if order == 1:
        newton_rows.launches_order1 += 1
    return refs, res


newton_rows.launches = 0  # kernel launches in this process
newton_rows.launches_order1 = 0  # of which at order 1 (the prefilter's)
