"""Unique-point deduplication + reconstruction indices.

Adjacent spectral elements share GLL nodes on their faces/edges, so a mesh
of E elements with (p+1)^d nodes each has ~2x fewer *unique* points (order
4).  Locating only the unique points and reconstructing afterwards is the
reference's key work-saver (reference multi_mesh/utils.py:465-515).  The
host numpy of the JAX package's ``ops/dedup.py``, bit for bit; the device
copy of the unique points is a ``torch.Tensor``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..hashing import content_fingerprint


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
    APPEARANCE in the flat input instead of lexicographic order.  Then
    ``max(recon[:m])`` is monotone in ``m``: every prefix of the input
    references only a prefix of the unique array, which lets the engine's
    file path expand and write the first elements while later chunks of
    unique values are still on their way from the device.
    """
    pts = np.asarray(points)
    if pts.ndim == 3:
        pts = pts.reshape(-1, pts.shape[-1])
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
    return unique, recon


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


_UNIQ_DEV_CACHE: dict = {}  # (fingerprint, order_by, device) -> unique


def unique_points_device(
    points: np.ndarray, fingerprint: int, order_by: str = "first",
    device="cuda",
) -> Tuple[torch.Tensor, np.ndarray]:
    """(unique points as a tensor on ``device``, host recon), both
    content-cached: repeat transfers onto one target keep the device copy
    alive alongside the host dedup (two entries, as the host cache)."""
    uniq, recon = unique_points_cached(points, fingerprint, order_by)
    key = (fingerprint, order_by, str(torch.device(device)))
    dev = _UNIQ_DEV_CACHE.get(key)
    if dev is None:
        if len(_UNIQ_DEV_CACHE) >= 2:
            _UNIQ_DEV_CACHE.clear()
        dev = torch.as_tensor(uniq, device=device)
        _UNIQ_DEV_CACHE[key] = dev
    return dev, recon


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
