"""Unique-point deduplication + reconstruction indices.

Adjacent spectral elements share GLL nodes on their faces/edges, so a mesh
of E elements with (p+1)^d nodes each has ~2x fewer *unique* points (order
4).  Locating only the unique points and reconstructing afterwards is the
reference's key work-saver (reference multi_mesh/utils.py:465-515).  The
host numpy of the JAX package's ``ops/dedup.py``, bit for bit; the device
copy of the unique points is a ``torch.Tensor``.

On a CUDA device the first-appearance dedup runs on the card
(``dedup_first``, sorts and scans in PyTorch), with the same unique rows,
in the same order, and the same reconstruction indices as the host path.
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


def dedup_first(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(unique [U, d], recon [N] int64) of ``points`` [N, d] f64 on their
    device, in first-appearance order, as
    ``unique_points(order_by="first")``.  Stable sorts by each column,
    the last first, make rows that compare equal (``==``: -0.0 equals
    +0.0, a NaN equals nothing) neighbours; a group's unique row is its
    first row.  Reading U is the one sync."""
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
    first, perm = torch.sort(first)  # new id -> group, by first appearance
    new_id = torch.empty_like(perm)
    new_id[perm] = torch.arange(n_groups, device=points.device)
    recon = torch.empty(n, dtype=torch.int64, device=points.device)
    recon[order] = new_id[group]
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
    device="cuda",
) -> Tuple[torch.Tensor, np.ndarray]:
    """(unique points as a tensor on ``device``, recon on the host) of
    ``points`` [E, n, d] or [N, d], content-cached: repeat transfers onto
    one target reuse both (two entries, as the host cache).

    On a CUDA device with ``order_by="first"`` the card groups the rows
    (``dedup_first``): the coordinates are uploaded once as f64 (exact
    for f32 ones, so the groups are the host path's), the unique points
    stay there and recon is copied back.  Otherwise the host path
    runs (``unique_points_cached``) and the unique points are uploaded."""
    device = torch.device(device)
    key = (fingerprint, order_by, str(device))
    hit = _UNIQ_DEV_CACHE.get(key)
    if hit is None:
        if device.type == "cuda" and order_by == "first":
            pts = np.asarray(points)
            # f64 (exact for f32 coordinates): the host path's groups
            flat = np.ascontiguousarray(pts.reshape(-1, pts.shape[-1]),
                                        dtype=np.float64)
            with warnings.catch_warnings():
                # a frozen lattice: it is only read
                warnings.filterwarnings("ignore", message=".*not writable")
                flat = torch.as_tensor(flat, device=device)
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
    points: np.ndarray, masks: Dict[str, np.ndarray]
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Per-layer dedup: layer -> (unique points, reconstruction indices).

    ``points`` [E, n, d]; ``masks`` layer -> boolean [E].  Mirrors the
    mesh path of the reference's get_unique_points (utils.py:503-515).
    """
    return {
        layer: unique_points(points[mask]) for layer, mask in masks.items()
    }
