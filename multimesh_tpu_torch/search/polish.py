"""K4 and K5: the accuracy polish of accepted pairs and its apply.

Counterpart of the JAX package's ``search/pallas_df32.py``:

* ``polish_pairs`` -- warm-started Newton steps on accepted (point,
  element) pairs, replacing ``polish_refs_rows`` (K4, kernel
  ``csrc/polish_pairs.cu``);
* ``apply_pairs`` -- the transfer operator's apply at (hi, lo) pair refs,
  replacing ``apply_refs_rows`` (K5, kernel ``csrc/apply_pairs.cu``).

The TPU kernels run in double-f32 pair arithmetic because the TPU has no
f64; the card has, so both kernels compute in f64 and keep the pair only
as the interface the operator stores: ``hi = f32(ref)``, ``lo = f32(ref -
hi)`` (``refs`` / ``refs_lo``).  ``polish_pairs_ref`` and
``apply_pairs_ref`` are their plain PyTorch twins in f64.

Each wrapper picks by the tensors' device: CPU tensors run the plain twin,
CUDA tensors launch the kernel, any other device raises.
"""
from __future__ import annotations

import torch

from .. import _build
from ..core import gll, shape
from .newton import group_rows

ORDERS = (1, 2, 3, 4, 5, 6, 7)  # the orders the kernels are compiled for
# A genuine polish step of an accepted f32 ref is O(f32 residual); a larger
# one means the update diverged and the caller keeps the f32 ref (the JAX
# package's _STEP_GUARD).
STEP_GUARD = 0.05


def polish_pairs_ref(points, ids, ref0, ctr, inv_scale, nodes64, order: int,
                     dim: int, iters: int):
    """Plain PyTorch twin of K4 (any device)."""
    E = ctr.shape[0]
    bad = (ids < 0) | (ids >= E)
    ids = ids.clamp(0, E - 1).long()  # out-of-range rows: NaN, not ok
    p_c = (points - ctr[ids]) * inv_scale[ids, None]
    rows = nodes64[ids].view(-1, (order + 1) ** dim, dim)
    ref = ref0.to(torch.float64)
    ok = torch.ones(ref.shape[:1], dtype=torch.bool, device=ref.device)
    for _ in range(iters):
        r = p_c - shape.forward_map(order, rows, ref)
        step, _ = shape._solve_small(shape.shape_jacobian(order, rows, ref), r)
        ok &= (step.abs() < STEP_GUARD).all(dim=-1)  # NaN: not ok
        ref = ref + torch.where(torch.isfinite(step), step, 0.0)
    ref = torch.where(bad[:, None], float("nan"), ref)
    hi = ref.to(torch.float32)
    return hi, (ref - hi.to(torch.float64)).to(torch.float32), ok & ~bad


def apply_pairs_ref(ref_hi, ref_lo, elements, fields, order: int, dim: int):
    """Plain PyTorch twin of K5 (any device)."""
    E = fields.shape[1]
    ref = ref_hi.to(torch.float64) + ref_lo.to(torch.float64)
    weights = gll.tensor_basis(order, ref)  # [M, n]
    gathered = fields[:, elements.clamp(0, E - 1).long(), :]  # [F, M, n]
    vals = (gathered * weights[None]).sum(dim=-1).T
    vals = torch.where((elements < 0)[:, None], 0.0, vals)
    return torch.where((elements >= E)[:, None], float("nan"), vals)


def _check(what, device, expect):
    """Raise unless every tensor of ``expect`` (name -> (tensor, dtype,
    shape)) has its dtype and shape, lies on ``device`` and is
    contiguous."""
    for name, (t, dtype, shp) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shp:
            raise ValueError(
                f"{what}: {name} must be {dtype} {shp}, got {t.dtype} "
                f"{tuple(t.shape)}")
        if t.device != device:
            raise ValueError(
                f"{what}: {name} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _kernel_device(what, device, order, dim):
    """True for a CUDA device whose kernel exists, False for the CPU;
    raise otherwise."""
    if dim not in (2, 3):
        raise ValueError(f"{what}: dim must be 2 or 3, got {dim}")
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    if order not in ORDERS:
        raise NotImplementedError(
            f"{what}: the kernel is built for orders {ORDERS}, got {order}")
    return True


def polish_pairs(points, ids, ref0, ctr, inv_scale, nodes64, order: int,
                 dim: int, iters: int):
    """``iters`` f64 Newton steps from the f32 warm starts ``ref0``.

    points [M, d] f64 physical coordinates, ids [M] int32 element ids,
    ref0 [M, d] f32; per element ``ctr`` [E, d] f64, ``inv_scale`` [E]
    f64 and the f64 unit-frame lattice ``nodes64`` [E, n*d].  Returns
    (ref_hi [M, d] f32, ref_lo [M, d] f32, ok [M] bool): ok is False where
    a step reached ``STEP_GUARD`` or was not finite; an id outside
    [0, E) gives NaN refs, not ok.  CUDA tensors launch K4 on the rows
    grouped by element, CPU tensors run the twin."""
    M = points.shape[0]
    E = ctr.shape[0]
    _check("polish_pairs", points.device, {
        "points": (points, torch.float64, (M, dim)),
        "ids": (ids, torch.int32, (M,)),
        "ref0": (ref0, torch.float32, (M, dim)),
        "ctr": (ctr, torch.float64, (E, dim)),
        "inv_scale": (inv_scale, torch.float64, (E,)),
        "nodes64": (nodes64, torch.float64, (E, (order + 1) ** dim * dim)),
    })
    device = points.device
    if not _kernel_device("polish_pairs", device, order, dim):
        return polish_pairs_ref(points, ids, ref0, ctr, inv_scale, nodes64,
                                order, dim, iters)
    if M == 0:
        hi = torch.empty((0, dim), dtype=torch.float32, device=device)
        return hi, hi.clone(), torch.empty(0, dtype=torch.bool, device=device)
    return _polish_kernel(group_rows(ids, E), points, ids, ref0, ctr,
                          inv_scale, nodes64, order, dim, iters)


def _polish_kernel(perm, points, ids, ref0, ctr, inv_scale, nodes64,
                   order: int, dim: int, iters: int):
    """Launch K4 over the rows in the order ``perm`` [M] int32 gives (any
    permutation gives the same bits; ``group_rows``' grouping makes it
    fast) on checked CUDA tensors."""
    M, E, device = points.shape[0], ctr.shape[0], points.device
    ref_hi = torch.empty((M, dim), dtype=torch.float32, device=device)
    ref_lo = torch.empty_like(ref_hi)
    ok = torch.empty((M,), dtype=torch.bool, device=device)
    lib = _build.library()
    err = lib.mmt_polish_pairs(
        points.data_ptr(), ids.data_ptr(), perm.data_ptr(), ref0.data_ptr(),
        ctr.data_ptr(), inv_scale.data_ptr(), nodes64.data_ptr(), M, E,
        order, dim, iters, ref_hi.data_ptr(), ref_lo.data_ptr(),
        ok.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(lib, err, "polish_pairs")
    polish_pairs.launches += 1
    return ref_hi, ref_lo, ok


def apply_pairs(ref_hi, ref_lo, elements, fields, order: int, dim: int):
    """Interpolated values [M, F] f64 at the pair refs ``ref_hi + ref_lo``
    ([M, d] f32 each) in elements [M] int32 of the f64 ``fields`` [F, E,
    n]; element -1 gives 0, an id >= E NaN.  CUDA tensors launch K5 on the
    rows grouped by element, CPU tensors run the twin."""
    M = ref_hi.shape[0]
    F, E = fields.shape[:2]
    _check("apply_pairs", ref_hi.device, {
        "ref_hi": (ref_hi, torch.float32, (M, dim)),
        "ref_lo": (ref_lo, torch.float32, (M, dim)),
        "elements": (elements, torch.int32, (M,)),
        "fields": (fields, torch.float64, (F, E, (order + 1) ** dim)),
    })
    device = ref_hi.device
    if not _kernel_device("apply_pairs", device, order, dim):
        return apply_pairs_ref(ref_hi, ref_lo, elements, fields, order, dim)
    if M == 0 or F == 0:
        return torch.empty((M, F), dtype=torch.float64, device=device)
    return _apply_kernel(group_rows(elements, E), ref_hi, ref_lo, elements,
                         fields, order, dim)


def _apply_kernel(perm, ref_hi, ref_lo, elements, fields, order: int,
                  dim: int):
    """Launch K5 over the rows in the order ``perm`` [M] int32 gives (any
    permutation gives the same bits; ``group_rows``' grouping makes it
    fast) on checked CUDA tensors."""
    M, (F, E) = ref_hi.shape[0], fields.shape[:2]
    out = torch.empty((M, F), dtype=torch.float64, device=ref_hi.device)
    lib = _build.library()
    err = lib.mmt_apply_pairs(
        ref_hi.data_ptr(), ref_lo.data_ptr(), elements.data_ptr(),
        perm.data_ptr(), fields.data_ptr(), M, E, F, order, dim,
        out.data_ptr(), torch.cuda.current_stream(ref_hi.device).cuda_stream,
    )
    _build.check(lib, err, "apply_pairs")
    apply_pairs.launches += 1
    return out


polish_pairs.launches = 0  # kernel launches in this process
apply_pairs.launches = 0
