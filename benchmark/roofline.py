"""Peaks of the card and the least time a kernel's work could take.

Frozen copies of ``chip_smoke.py:323-325`` (the peaks), ``:407-413``
(``bound``), ``:420-429`` (``sumfact_fmas``) and ``:432-444``
(``newton_bound``), on counts instead of tensors.
"""
from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA's data sheet; at 700 W): f32
# and f64 outside the tensor cores, HBM3
PEAK_F32, PEAK_F64, PEAK_BYTES = 67e12, 34e12, 3.35e12


def bound(flop: float, peak: float, nbytes: float):
    """The least seconds the card could take for the work: the larger of
    its operations over the peak rate of their type and its bytes (each
    input read once, each output written once) over the memory rate, as
    (seconds, "operations" | "bytes")."""
    op_s, byte_s = flop / peak, nbytes / PEAK_BYTES
    return (op_s, "operations") if op_s >= byte_s else (byte_s, "bytes")


def sumfact_fmas(order: int, dim: int, jac: bool) -> int:
    """FMAs of one sum-factorised evaluation of one component over the
    order-``order`` lattice: the value alone, or with ``jac`` the value
    and its ``dim`` derivatives.  The least work of such an evaluation;
    the 1-D bases and a Newton solve, under a tenth of it, are left out,
    so a bound from it slightly underestimates."""
    n = order + 1
    if dim == 3:
        return 2 * n**3 + 3 * n**2 + 4 * n if jac else n**3 + n**2 + n
    return 2 * n**2 + 3 * n if jac else n**2 + n


def newton_work(rows: int, elements: int, order: int, dim: int, iters: int):
    """(FLOP, bytes) of K1 solving ``rows`` (point, element) rows over
    ``elements`` distinct elements: per row ``iters`` evaluations of x and
    J and one of x for the residual, ``dim`` components each, 2 FLOP an
    FMA, in f32; the bytes of each row (f64 point, int32 id, f32 refs
    and residual) and of the f32 lattice, f64 centre and f64 scale of
    each element, once."""
    per_row = dim * (iters * sumfact_fmas(order, dim, True)
                     + sumfact_fmas(order, dim, False))
    row_bytes = 8 * dim + 4 + 4 * dim + 4
    elem_bytes = 8 * dim + 8 + 4 * dim * (order + 1) ** dim
    return 2 * per_row * rows, row_bytes * rows + elem_bytes * elements


def nearest_work(rows: int, sources: int, dim: int):
    """(FLOP, bytes) of K2 picking the nearest of ``sources`` f64
    centroids for ``rows`` f64 queries: ``dim`` f32 FMAs a pair; each
    query and centroid read once, an int32 pick written."""
    return 2 * dim * rows * sources, (8 * dim + 4) * rows + 8 * dim * sources
