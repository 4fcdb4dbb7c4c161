"""Plain reference of upstream MultiMesh's layered GLL-to-GLL transfer
(``gll_2_gll_layered``, ``gll_2_gll_layered_multi``): the nodal values of
an order-N GLL source mesh carried onto target points, each point located
only among the source elements of its own layer, so that no value is
taken across a discontinuity of the model.

Upstream (``multi_mesh/components/interpolator.py:288-618``), as the port
documents it (``engine.gll_2_gll_layered``, ``search/locate.py``), for
each layer and each target slot of that layer:

* the ``nelem_to_search`` elements of the layer whose centroids lie
  nearest, in distance order;
* for each, whether the slot lies in the element's axis-aligned bounding
  box (the AABB prefilter), and the inverse of the element's order-N GLL
  map by Newton's method;
* the first candidate in distance order whose box holds the slot and
  whose reference coordinates all lie within ``ACCEPT`` = 1.04 is taken;
* otherwise the fallback of ``_check_if_inside_element``: the first
  candidate whose box holds the slot, else the candidate whose box centre
  lies nearest; its reference coordinates where they converged within
  ``ACCEPT``, else the fixed interior coordinate ``FALLBACK_REF``;
* the value is the element's order-N Lagrange interpolant of its nodal
  values at those coordinates.

Departures from upstream:

* the candidates come from brute force (``torch.cdist`` + ``topk``) over
  the layer's element centroids (the means of their nodes) in place of a
  KD-tree; the two give the same list up to the order of exactly
  equidistant centroids;
* Newton runs a fixed ``NEWTON_STEPS`` steps in float64 from the centre of
  each element's own frame (its box centre, scaled by half its largest
  extent); a candidate whose residual stays above ``CONV_TOL`` of that
  frame is passed over; upstream iterates with its own stopping rule;
* candidate columns are tried one after another and only for the slots
  no earlier column accepted: the same choice as trying every column;
* every slot is located, with no dedup (upstream locates each layer's
  unique points; duplicate slots have identical coordinates, so the
  answers are the same);
* the layers are the caller's ids (``"nocore"``, ``"all"`` and the other
  names are resolved before): every layer that occurs among the targets
  is carried, and a slot whose layer holds no source element is NaN
  (upstream leaves the values of a layer it does not carry as they were);
* the values are float64 (the port applies float32 coefficients).

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

ACCEPT = 1.04
FALLBACK_REF = (0.645, -0.5, 0.22)
NEWTON_STEPS = 25
CONV_TOL = 1e-9
# AABB slack relative to the element's extent: a slot on a face must never
# be excluded by rounding
AABB_RTOL = 1e-9
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


def _locate_layer(lattice: torch.Tensor, targets: torch.Tensor, k: int,
                  order: int, block: int):
    """(element [S] long into ``lattice`` [E, n, 3], xi [S, 3]) of each of
    ``targets`` [S, 3] (S > 0) among the elements of one layer."""
    centroids = lattice.mean(dim=1)
    lo, hi = lattice.amin(dim=1), lattice.amax(dim=1)
    eps = AABB_RTOL * (hi - lo)
    lo, hi = lo - eps, hi + eps
    fallback = torch.tensor(FALLBACK_REF, dtype=torch.float64,
                            device=lattice.device)
    rows_per_block = max(1, min(block, _DIST_ENTRIES // lattice.shape[0]))
    elems, xis = [], []
    for s in range(0, targets.shape[0], rows_per_block):
        q = targets[s:s + rows_per_block]
        cand = torch.cdist(q, centroids).topk(
            k, dim=1, largest=False, sorted=True).indices  # [B, k]
        elem = cand[:, 0].clone()
        xi = torch.zeros_like(q)
        accepted = torch.zeros(q.shape[0], dtype=torch.bool,
                               device=q.device)
        for c in range(k):
            rows = (~accepted).nonzero()[:, 0]
            if not rows.numel():
                break
            e, qr = cand[rows, c], q[rows]
            x, conv = newton(lattice[e], qr, order)
            inside = ((qr >= lo[e]) & (qr <= hi[e])).all(dim=-1)
            ok = conv & inside & (x.abs().amax(dim=-1) <= ACCEPT)
            elem[rows[ok]], xi[rows[ok]] = e[ok], x[ok]
            accepted[rows[ok]] = True
        rows = (~accepted).nonzero()[:, 0]
        if rows.numel():
            c, qr = cand[rows], q[rows]
            in_box = ((qr[:, None] >= lo[c]) & (qr[:, None] <= hi[c])
                      ).all(dim=-1)
            dist = ((qr[:, None] - (lo[c] + hi[c]) / 2.0) ** 2).sum(dim=-1)
            pick = torch.where(in_box.any(dim=1),
                               in_box.to(torch.int8).argmax(dim=1),
                               dist.argmin(dim=1))
            e = c[torch.arange(rows.numel(), device=c.device), pick]
            x, conv = newton(lattice[e], qr, order)
            bad = ~conv | (x.abs().amax(dim=-1) > ACCEPT)
            elem[rows] = e
            xi[rows] = torch.where(bad[:, None], fallback, x)
        elems.append(elem)
        xis.append(xi)
    return torch.cat(elems), torch.cat(xis)


def locate(lattice, element_layer, targets, target_layer,
           nelem_to_search: int = 20, device=None, block: int = 16384):
    """(element [S] long, xi [S, 3] f64) of each target [S, 3] among the
    source elements ``lattice`` [E, n, 3] whose ``element_layer`` [E] is
    the target's ``target_layer`` [S], ``block`` targets at a time, on
    ``device`` (default: the device ``lattice`` is on, or the CPU for host
    arrays).  Where the target's layer holds no source element, element
    is -1 and xi is 0."""
    lat = _tensor(lattice)
    device = torch.device(device) if device is not None else lat.device
    lat = lat.to(device=device, dtype=torch.float64)
    order = _order_of(lat.shape[1])
    pts = _tensor(targets).to(device=device, dtype=torch.float64)
    pts = pts.reshape(-1, 3)
    group = _tensor(element_layer).to(device=device, dtype=torch.long)
    tgt_group = _tensor(target_layer).to(device=device, dtype=torch.long)
    tgt_group = tgt_group.reshape(-1)
    if tgt_group.shape[0] != pts.shape[0]:
        raise ValueError(f"{pts.shape[0]} targets and {tgt_group.shape[0]} "
                         "target layers")
    element = torch.full((pts.shape[0],), -1, dtype=torch.long,
                         device=device)
    xi = torch.zeros_like(pts)
    with _exact_matmul():
        for g in torch.unique(tgt_group).tolist():
            members = (group == g).nonzero()[:, 0]
            if not members.numel():
                continue
            rows = (tgt_group == g).nonzero()[:, 0]
            e, x = _locate_layer(lat[members], pts[rows],
                                 min(int(nelem_to_search), members.numel()),
                                 order, block)
            element[rows], xi[rows] = members[e], x
    return element, xi


def interpolate(values, element: torch.Tensor, xi: torch.Tensor,
                dtype: torch.dtype = torch.float64,
                block: int = 16384) -> torch.Tensor:
    """[S, P] float64: the nodal ``values`` [P, E, n] at each target's
    (``element``, ``xi``), computed in ``dtype``, ``block`` targets at a
    time; NaN where ``element`` is -1."""
    v = _tensor(values).to(device=xi.device)
    order = _order_of(v.shape[-1])
    out = torch.full((xi.shape[0], v.shape[0]), float("nan"),
                     dtype=torch.float64, device=xi.device)
    for s in range(0, xi.shape[0], block):
        e = element[s:s + block]
        w = basis(order, xi[s:s + block].to(dtype))  # [B, n]
        vals = v[:, e.clamp(min=0), :].to(dtype)  # [P, B, n]
        got = (vals * w[None]).sum(dim=-1).T.to(torch.float64)
        out[s:s + block] = torch.where(e[:, None] >= 0, got, out[s:s + block])
    return out


def gll_2_gll_layered(lattice, element_layer, values, targets, target_layer,
                      nelem_to_search: int = 20, device=None,
                      block: int = 16384) -> torch.Tensor:
    """[S, P] float64: the source's nodal ``values`` [P, E, n] on the
    elements ``lattice`` [E, n, 3] of layers ``element_layer`` [E],
    carried onto the ``targets`` [..., 3] of layers ``target_layer``
    [...] (one per target), each located only among its own layer's
    elements; NaN where that layer holds no source element."""
    element, xi = locate(lattice, element_layer, targets, target_layer,
                         nelem_to_search, device, block)
    return interpolate(values, element, xi, block=block)
