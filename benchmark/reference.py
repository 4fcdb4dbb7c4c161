"""Plain reference of a GLL-to-points transfer, in PyTorch, f64.

For each target: the source elements whose centroids lie nearest (brute
force over every centroid), a Newton inverse map x(xi) = q of each in
float64 on the tensor-product Lagrange basis, the first candidate in
distance order whose reference coordinates lie in [-1, 1]^3, and the
field interpolated there.  It reads only the inputs the benchmark hands
to the program (the source lattice, the source values, the targets) and
shares no code with the program; the GLL nodes and the node order are the
benchmark's own (``meshes``).

``interpolate(..., dtype=...)`` also serves the control: the same
interpolation with the basis, the values and the sums in a lower
precision.
"""
from __future__ import annotations

import torch

from . import meshes

# a candidate contains the target when every |xi| is at most this: the
# f64 Newton solve converges to ~1e-14, and a target on a shared face
# lies in both elements
INSIDE_TOL = 1e-9
NEWTON_STEPS = 25
CANDIDATES = 27  # the 3 x 3 x 3 neighbourhood of a structured mesh


def lagrange(order: int, x: torch.Tensor, deriv: bool = False):
    """All order + 1 Lagrange cardinal polynomials on the GLL nodes at
    ``x`` [...] -> [..., order + 1] (or their derivatives), in the dtype
    of ``x``."""
    nodes = [float(v) for v in meshes.gll_nodes(order)]
    cols = []
    for i, xi in enumerate(nodes):
        others = [xj for j, xj in enumerate(nodes) if j != i]
        denom = 1.0
        for xj in others:
            denom *= xi - xj
        if not deriv:
            prod = torch.ones_like(x)
            for xj in others:
                prod = prod * (x - xj)
            cols.append(prod / denom)
        else:
            total = torch.zeros_like(x)
            for k in range(len(others)):
                prod = torch.ones_like(x)
                for m, xj in enumerate(others):
                    if m != k:
                        prod = prod * (x - xj)
                total = total + prod
            cols.append(total / denom)
    return torch.stack(cols, dim=-1)


def basis(order: int, xi: torch.Tensor) -> torch.Tensor:
    """Tensor-product basis at ``xi`` [..., 3] -> [..., (order + 1)^3],
    node (i, j, k) at flat index (i * n + j) * n + k."""
    l0, l1, l2 = (lagrange(order, xi[..., a]) for a in range(3))
    out = l0[..., :, None, None] * l1[..., None, :, None] * l2[..., None, None, :]
    return out.flatten(-3)


def basis_grad(order: int, xi: torch.Tensor) -> torch.Tensor:
    """d basis / d xi: [..., (order + 1)^3, 3]."""
    ls = [lagrange(order, xi[..., a]) for a in range(3)]
    ds = [lagrange(order, xi[..., a], deriv=True) for a in range(3)]
    cols = []
    for axis in range(3):
        f = [ds[b] if b == axis else ls[b] for b in range(3)]
        out = f[0][..., :, None, None] * f[1][..., None, :, None] \
            * f[2][..., None, None, :]
        cols.append(out.flatten(-3))
    return torch.stack(cols, dim=-1)


def _newton(order: int, nodes: torch.Tensor, q: torch.Tensor):
    """xi [..., 3] with x(xi) = q on each element's ``nodes`` [..., n, 3],
    solved in the element's own frame (centred, scaled to unit size);
    returns (xi, residual in that frame)."""
    ctr = nodes.mean(dim=-2, keepdim=True)
    scale = (nodes.amax(dim=-2) - nodes.amin(dim=-2)).amax(dim=-1) / 2.0
    scale = scale[..., None, None]
    x = (nodes - ctr) / scale
    p = ((q[..., None, :] - ctr) / scale)[..., 0, :]
    xi = torch.zeros_like(p)
    for _ in range(NEWTON_STEPS):
        r = (basis(order, xi)[..., None] * x).sum(dim=-2) - p
        jac = torch.einsum("...na,...nb->...ab", x, basis_grad(order, xi))
        step = torch.linalg.solve_ex(jac, r[..., None])[0][..., 0]
        xi = (xi - step).nan_to_num(4.0, 4.0, -4.0).clamp(-4.0, 4.0)
    r = (basis(order, xi)[..., None] * x).sum(dim=-2) - p
    return xi, r.abs().amax(dim=-1)


def locate(lattice: torch.Tensor, targets: torch.Tensor, order: int,
           block: int = 8192, inside_tol: float = INSIDE_TOL,
           miss: bool = False):
    """(element [S] long, xi [S, 3] f64, found [S] bool) of each target
    [S, 3] in the source ``lattice`` [E, n, 3] (f64, on the device the
    work runs on), ``block`` targets at a time.  ``found`` is False where
    none of the nearest ``CANDIDATES`` elements contains the target;
    there ``xi`` is the nearest miss, clipped into the element.

    ``inside_tol`` (at least ``INSIDE_TOL``) widens containment: where no
    candidate contains a target at ``INSIDE_TOL``, the first candidate in
    distance order within ``inside_tol`` of [-1, 1]^3 does, and ``xi`` is
    clipped into it.  With ``miss``, a fourth tensor [S] f64: how far the
    chosen candidate's largest |xi| lies past 1 (0 inside)."""
    lattice = lattice.to(torch.float64)
    targets = targets.to(device=lattice.device, dtype=torch.float64)
    centroids = lattice.mean(dim=1)
    k = min(CANDIDATES, lattice.shape[0])
    # the [rows, E] distances in pieces of at most 2**27 entries (1 GiB)
    rows = max(1, min(block, 2**27 // lattice.shape[0]))
    cand = torch.cat([
        torch.cdist(targets[s:s + rows], centroids)
        .topk(k, largest=False).indices
        for s in range(0, targets.shape[0], rows)])
    elems, xis, founds, misses = [], [], [], []
    for s in range(0, targets.shape[0], block):
        c = cand[s:s + block]
        q = targets[s:s + block, None, :].expand(-1, k, -1)
        xi, res = _newton(order, lattice[c], q)
        outside = xi.abs().amax(dim=-1)
        inside = (outside <= 1.0 + INSIDE_TOL) & (res < 1e-9)
        if inside_tol != INSIDE_TOL:
            inside |= ((outside <= 1.0 + inside_tol) & (res < 1e-9)
                       & ~inside.any(dim=1, keepdim=True))
        # first containing candidate in distance order, else the nearest miss
        first = torch.where(inside.any(dim=1),
                            inside.to(torch.int8).argmax(dim=1),
                            outside.argmin(dim=1))
        r = torch.arange(c.shape[0], device=c.device)
        elems.append(c[r, first])
        xis.append(xi[r, first].clamp(-1.0, 1.0))
        founds.append(inside.any(dim=1))
        if miss:
            misses.append((outside[r, first] - 1.0).clamp_min(0.0))
    if not elems:
        empty = torch.zeros((0,), dtype=torch.long, device=lattice.device)
        out = (empty, torch.zeros((0, 3), dtype=torch.float64,
                                  device=lattice.device), empty.bool())
        return out + (empty.double(),) if miss else out
    out = torch.cat(elems), torch.cat(xis), torch.cat(founds)
    return out + (torch.cat(misses),) if miss else out


def interpolate(values: torch.Tensor, element: torch.Tensor,
                xi: torch.Tensor, order: int,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """[S, P] f64: ``values`` [P, E, n] of the source at each target's
    (``element``, ``xi``), computed in ``dtype``."""
    w = basis(order, xi.to(dtype))  # [S, n]
    v = values[:, element, :].to(dtype)  # [P, S, n]
    return (v * w[None]).sum(dim=-1).T.to(torch.float64)
