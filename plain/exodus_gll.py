"""Plain reference of upstream MultiMesh's ``exodus_2_gll``: nodal fields
of a trilinear hex (Exodus) mesh interpolated onto the slots of a GLL
mesh.

Upstream (``multi_mesh/components/interpolator.py:142-224`` with the C
kernel ``src/trilinearinterpolator.c:93-137``), for each target slot:

* the ``nelem_to_search`` hexes whose centroids lie nearest, in distance
  order;
* for each, the inverse of its trilinear map by Newton's method in
  double precision;
* the first candidate with every |reference coordinate| at most
  ``ACCEPT`` = 1.025 is taken; if none is, the candidate with the least
  max |reference coordinate| seen (best so far), if that is below
  ``FALLBACK_MAX`` = 1.5; otherwise the slot is missing and the call
  raises;
* the value is the sum of the 8 trilinear weights times the hex's nodal
  values.

Departures from upstream:

* the candidates come from brute force (``torch.cdist`` + ``topk``) in
  place of a KD-tree; the two give the same list up to the order of
  exactly equidistant centroids;
* Newton runs a fixed ``NEWTON_STEPS`` steps from the centre in each
  hex's own frame (centred, scaled by half its largest extent) and a
  candidate whose residual stays above ``CONV_TOL`` of that frame is
  passed over; upstream iterates to 1e-8 of the hex's scale with an early
  exit (at most 50 steps);
* the values are rounded to float32, as the port writes them (upstream
  writes float64 into the file).

Corner order is the canonical tensor-product order of the port's order-1
lattice: corner ``(i * 2 + j) * 2 + k`` sits at reference coordinates
(2i - 1, 2j - 1, 2k - 1).  Only ``torch`` and ``numpy`` are imported;
the work runs in float64 on the device of ``device`` (any).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

ACCEPT = 1.025
FALLBACK_MAX = 1.5
NEWTON_STEPS = 30
CONV_TOL = 1e-9
# reference coordinates of the 8 corners [8, 3], canonical order
CORNERS = torch.tensor([[2 * i - 1, 2 * j - 1, 2 * k - 1]
                        for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                       dtype=torch.float64)


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


def trilinear_weights(xi: torch.Tensor) -> torch.Tensor:
    """The 8 trilinear weights [..., 8] at reference coordinates
    ``xi`` [..., 3]: prod over a of (1 + c_a xi_a) / 2."""
    c = CORNERS.to(device=xi.device, dtype=xi.dtype)
    return ((1.0 + xi[..., None, :] * c) / 2.0).prod(dim=-1)


def trilinear_grad(xi: torch.Tensor) -> torch.Tensor:
    """d weights / d xi: [..., 8, 3]."""
    c = CORNERS.to(device=xi.device, dtype=xi.dtype)
    f = (1.0 + xi[..., None, :] * c) / 2.0  # [..., 8, 3]
    cols = []
    for a in range(3):
        others = [f[..., b] for b in range(3) if b != a]
        cols.append(c[:, a] / 2.0 * others[0] * others[1])
    return torch.stack(cols, dim=-1)


def inverse_map(corners: torch.Tensor, q: torch.Tensor):
    """Reference coordinates [..., 3] of the points ``q`` [..., 3] in the
    hexes ``corners`` [..., 8, 3] (float64), and whether Newton converged
    [...]."""
    ctr = corners.mean(dim=-2, keepdim=True)
    scale = (corners.amax(dim=-2) - corners.amin(dim=-2)).amax(dim=-1)
    scale = scale[..., None, None] / 2.0
    x = (corners - ctr) / scale
    p = (q - ctr[..., 0, :]) / scale[..., 0]
    xi = torch.zeros_like(p)
    for _ in range(NEWTON_STEPS):
        r = (trilinear_weights(xi)[..., None] * x).sum(dim=-2) - p
        jac = torch.einsum("...nd,...na->...da", x, trilinear_grad(xi))
        step = torch.linalg.solve_ex(jac, r[..., None])[0][..., 0]
        xi = (xi - step).nan_to_num(8.0, 8.0, -8.0).clamp(-8.0, 8.0)
    r = (trilinear_weights(xi)[..., None] * x).sum(dim=-2) - p
    return xi, r.abs().amax(dim=-1) < CONV_TOL


def locate(corner_nodes, points, nelem_to_search: int = 20, device=None,
           block: int = 8192):
    """(element [N] long, weights [N, 8] f64, found [N] bool) of each point
    [N, 3] in the hexes ``corner_nodes`` [E, 8, 3], ``block`` points at a
    time, on ``device`` (default: the device ``corner_nodes`` is on, or
    the CPU for host arrays).  Where ``found`` is False, element is -1 and
    the weights are 0."""
    corners = _tensor(corner_nodes)
    device = torch.device(device) if device is not None else corners.device
    corners = corners.to(device=device, dtype=torch.float64)
    pts = _tensor(points).to(device=device, dtype=torch.float64)
    centroids = corners.mean(dim=1)
    k = min(int(nelem_to_search), corners.shape[0])
    elems, weights, founds = [], [], []
    with _exact_matmul():
        for s in range(0, pts.shape[0], block):
            q = pts[s:s + block]
            cand = torch.cdist(q, centroids).topk(
                k, dim=1, largest=False, sorted=True).indices  # [B, k]
            xi, conv = inverse_map(corners[cand], q[:, None, :].expand(
                -1, k, -1))
            worst = torch.where(conv, xi.abs().amax(dim=-1),
                                torch.full_like(xi[..., 0], float("inf")))
            accepted = worst <= ACCEPT
            has = accepted.any(dim=1)
            best = worst.argmin(dim=1)  # the first of equal minima
            pick = torch.where(has, accepted.to(torch.int8).argmax(dim=1),
                               best)
            r = torch.arange(q.shape[0], device=device)
            found = has | (worst[r, best] < FALLBACK_MAX)
            w = trilinear_weights(xi[r, pick])
            elems.append(torch.where(found, cand[r, pick], -1))
            weights.append(torch.where(found[:, None], w, 0.0))
            founds.append(found)
    return torch.cat(elems), torch.cat(weights), torch.cat(founds)


def interpolate(fields, element: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """[N, F] float64: the nodal ``fields`` [F, E, 8] at each point's
    (element, weights)."""
    f = _tensor(fields).to(device=weights.device, dtype=torch.float64)
    return (f[:, element.clamp(min=0), :] * weights[None]).sum(dim=-1).T


def exodus_2_gll(corner_nodes, fields, coords, nelem_to_search: int = 20,
                 device=None, block: int = 8192) -> torch.Tensor:
    """[npoints, F, n_gll] float32: the nodal ``fields`` [F, E, 8] of the
    hexes ``corner_nodes`` [E, 8, 3] at every slot of ``coords``
    [npoints, n_gll, 3], in the layout of a Salvus ``MODEL/data``
    dataset.  Raises RuntimeError if a slot lies in no hex."""
    npoints, n_gll, dim = coords.shape
    element, weights, found = locate(
        corner_nodes, _tensor(coords).reshape(-1, dim),
        nelem_to_search, device, block)
    missing = int((~found).sum())
    if missing:
        raise RuntimeError(f"{missing} points could not be interpolated.")
    values = interpolate(fields, element, weights)
    return values.to(torch.float32).reshape(npoints, n_gll, -1).transpose(1, 2)
