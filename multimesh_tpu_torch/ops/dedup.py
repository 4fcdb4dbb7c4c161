"""Unique-point deduplication + reconstruction indices.

Adjacent spectral elements share GLL nodes on their faces/edges, so a mesh
of E elements with (p+1)^d nodes each has ~2x fewer *unique* points (order
4).  Locating only the unique points and reconstructing afterwards is the
reference's key work-saver (reference multi_mesh/utils.py:465-515).  The
host numpy of the JAX package's ``ops/dedup.py``, bit for bit; the device
copy of the unique points is a ``torch.Tensor``.

On a CUDA device the dedup runs on the card (``dedup_first`` for the
mesh path's first-appearance order, ``dedup_sorted`` for the layered
path's sorted order; sorts and scans in PyTorch), with the same unique
rows, in the same order, and the same reconstruction indices as the host
path.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from ..hashing import content_fingerprint
from ..utils_profile import count


def unique_points(
    points: np.ndarray, order_by: str = "sorted"
) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten [E, n, d] (or accept [N, d]) and dedup exactly.

    Returns (unique [U, d], recon [E*n]) with
    ``unique[recon] == points.reshape(-1, d)`` -- the same contract as
    np.unique(..., return_inverse=True, axis=0) which the reference uses
    (utils.py:484-488), but implemented via lexsort (np.unique's axis-0
    path is substantially slower at the 1e7+ point counts we target).

    ``order_by="first"`` relabels the unique points in order of FIRST
    APPEARANCE in the flat input instead of lexicographic order: the
    order of the file path's operator rows and ``recon.npy`` in both
    packages.
    """
    pts = np.asarray(points)
    if pts.ndim == 3:
        pts = pts.reshape(-1, pts.shape[-1])
    count("dedup.host_rows", len(pts))
    order = np.lexsort(pts.T[::-1])
    spts = pts[order]
    is_new = np.empty(len(spts), dtype=bool)
    is_new[0] = True
    np.any(spts[1:] != spts[:-1], axis=1, out=is_new[1:])
    group = np.cumsum(is_new) - 1
    unique = spts[is_new]
    recon = np.empty(len(pts), dtype=np.int64)
    recon[order] = group
    if order_by == "first":
        starts = np.nonzero(is_new)[0]
        # first original index of each (sorted-order) group; groups are
        # contiguous runs of `order` -> one segmented min
        first_orig = np.minimum.reduceat(order, starts)
        perm = np.argsort(first_orig, kind="stable")  # newid -> oldid
        inv = np.empty(len(perm), np.int64)
        inv[perm] = np.arange(len(perm))
        unique = unique[perm]
        recon = inv[recon]
    elif order_by != "sorted":
        raise ValueError(f"unknown order_by {order_by!r}")
    count("dedup.unique_rows", len(unique))
    return unique, recon


def _sorted_groups(points: torch.Tensor):
    """(order, group, first) of ``points`` [N, d] f64 on their device:
    ``order`` sorts the rows lexicographically, ``group`` [N] numbers the
    sorted rows' groups from 0, ``first`` [U] is each group's first row
    (its least input index).  Stable sorts by each column, the last first,
    make rows that compare equal (``==``: -0.0 equals +0.0, a NaN equals
    nothing) neighbours in ``np.lexsort``'s order.  Reading U is the one
    sync."""
    n = points.shape[0]
    keys = points + 0.0  # -0.0 + 0.0 is +0.0: one sort key per == class
    order = torch.arange(n, device=points.device)
    for c in reversed(range(points.shape[1])):
        order = order[torch.sort(keys[order, c], stable=True).indices]
    spts = keys[order]
    is_new = torch.ones(n, dtype=torch.bool, device=points.device)
    is_new[1:] = (spts[1:] != spts[:-1]).any(dim=1)
    group = torch.cumsum(is_new, 0) - 1
    n_groups = int(is_new.sum())
    first = torch.full((n_groups,), n, device=points.device).scatter_reduce(
        0, group, order, "amin")
    return order, group, first


def dedup_first(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique [U, d], recon [N] int64) of ``points`` [N, d] f64 on their
    device, in first-appearance order, as
    ``unique_points(order_by="first")``: ``_sorted_groups`` relabelled;
    a group's unique row is its first row."""
    order, group, first = _sorted_groups(points)
    first, perm = torch.sort(first)  # new id -> group, by first appearance
    new_id = torch.empty_like(perm)
    new_id[perm] = torch.arange(len(perm), device=points.device)
    recon = torch.empty(len(order), dtype=torch.int64, device=points.device)
    recon[order] = new_id[group]
    return points[first], recon


def dedup_sorted(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique [U, d], recon [N] int64) of ``points`` [N, d] f64 on their
    device, in sorted order, as ``unique_points(order_by="sorted")``:
    ``_sorted_groups`` without the relabelling; a group's unique row is
    its first row in the stable sorted order, the row ``np.lexsort``
    keeps (sign of zero included)."""
    order, group, first = _sorted_groups(points)
    recon = torch.empty(len(order), dtype=torch.int64, device=points.device)
    recon[order] = group
    return points[first], recon


_UNIQ_CACHE: dict = {}  # (content fingerprint, order_by) -> (unique, recon)


def unique_points_cached(
    points: np.ndarray, fingerprint: int | None = None,
    order_by: str = "sorted",
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`unique_points` behind an in-process content-keyed cache.

    The host lexsort is the largest host stage of a file transfer while
    the content fingerprint runs at memory speed, so repeated transfers
    onto the same target mesh -- the dominant production pattern, and the
    reason the reference caches interpolation weights at all -- skip the
    dedup entirely.  Callers that already fingerprinted the points pass it
    in to avoid a second hash.  Two entries only: (uniq, recon) of a
    10M-slot target is ~200 MB of host memory an entry."""
    if fingerprint is None:
        fingerprint = content_fingerprint(np.asarray(points))
    key = (fingerprint, order_by)
    hit = _UNIQ_CACHE.get(key)
    if hit is None:
        if len(_UNIQ_CACHE) >= 2:
            _UNIQ_CACHE.clear()
        hit = unique_points(points, order_by=order_by)
        _UNIQ_CACHE[key] = hit
    return hit


_UNIQ_DEV_CACHE: dict = {}  # (fingerprint, order_by, device) -> (unique, recon)


def unique_points_device(
    points: np.ndarray, fingerprint: int, order_by: str = "first",
    device="cuda", uploaded: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, np.ndarray]:
    """(unique points as a tensor on ``device``, recon on the host) of
    ``points`` [E, n, d] or [N, d], content-cached: repeat transfers onto
    one target reuse both (two entries, as the host cache).

    On a CUDA device with ``order_by="first"`` the card groups the rows
    (``dedup_first``) in f64 (exact for f32 coordinates, so the groups
    are the host path's): ``uploaded``, ``points`` already on the card
    as ``hashing.content_fingerprint_device`` leaves them, is widened
    there; without it the coordinates are uploaded once as f64.  The
    unique points stay on the card and recon is copied back.  Otherwise
    the host path runs (``unique_points_cached``) and the unique points
    are uploaded."""
    device = torch.device(device)
    key = (fingerprint, order_by, str(device))
    hit = _UNIQ_DEV_CACHE.get(key)
    if hit is None:
        if device.type == "cuda" and order_by == "first":
            if uploaded is None:
                pts = np.asarray(points)
                flat = np.ascontiguousarray(pts.reshape(-1, pts.shape[-1]),
                                            dtype=np.float64)
                with warnings.catch_warnings():
                    # a frozen lattice: it is only read
                    warnings.filterwarnings("ignore",
                                            message=".*not writable")
                    flat = torch.as_tensor(flat, device=device)
            else:
                flat = uploaded.reshape(-1, uploaded.shape[-1]).to(
                    torch.float64)
            uniq, recon = dedup_first(flat)
            count("dedup.card_rows", len(flat))
            count("dedup.unique_rows", len(uniq))
            hit = (uniq, recon.cpu().numpy())
        else:
            uniq, recon = unique_points_cached(points, fingerprint, order_by)
            hit = (torch.as_tensor(uniq, device=device), recon)
        if len(_UNIQ_DEV_CACHE) >= 2:
            _UNIQ_DEV_CACHE.clear()
        _UNIQ_DEV_CACHE[key] = hit
    return hit


def unique_points_per_layer(
    points: np.ndarray, masks: Dict[str, np.ndarray], device=None,
) -> Dict[str, tuple]:
    """Per-layer dedup: layer -> (unique points, reconstruction indices),
    each layer's unique rows in sorted order (``interp_info.h5`` stores
    its coefficients in that order).

    ``points`` [E, n, d]; ``masks`` layer -> boolean [E].  Mirrors the
    mesh path of the reference's get_unique_points (utils.py:503-515).
    On a CUDA ``device`` the card groups each layer's rows
    (``dedup_sorted``) and both arrays are tensors there: the coordinates
    are uploaded once and widened to f64 on the card (exact, so the
    groups are the host path's), the unique rows cast back to the input's
    dtype.  Otherwise each layer runs the host lexsort (numpy arrays)."""
    if device is None or torch.device(device).type != "cuda":
        return {
            layer: unique_points(points[mask])
            for layer, mask in masks.items()
        }
    pts = np.ascontiguousarray(points)
    with warnings.catch_warnings():
        # a frozen lattice: it is only read
        warnings.filterwarnings("ignore", message=".*not writable")
        dev_pts = torch.as_tensor(pts, device=device)
    out = {}
    for layer, mask in masks.items():
        elems = torch.as_tensor(np.flatnonzero(mask), device=device)
        rows = dev_pts.index_select(0, elems).reshape(-1, pts.shape[-1])
        uniq, recon = dedup_sorted(rows.to(torch.float64))
        count("dedup.card_rows", len(rows))
        count("dedup.unique_rows", len(uniq))
        out[layer] = (uniq.to(dev_pts.dtype), recon)
    return out
