"""Nearest-source searches of the locate ladder.

Counterpart of the parts of the JAX package's ``search/knn.py`` the ladder
uses:

* ``nearest_centroid``: the chunk loop around K2 (``search.nearest``) that
  gives round 1 its single candidate;
* ``knn``: exact k nearest sources, for round 4 and, through
  ``grid.knn_any``, the scan and the scan retry of sources up to 131,072
  elements (beyond, and in every round of the ladder above 16,384,
  ``search.grid`` probes its balanced-bin index instead: a [rows, E]
  block here is 67 rows at E = 500,000).  On
  the card it is f64 distances plus ``torch.topk``; the JAX package's
  two-stage group top-k and split-f32 re-rank worked around TPU
  ``top_k`` and emulated f64, which the card does not need;
* ``centred_topk``: the rescue rounds' top-k over the jointly centred f32
  centroids (exact, where the JAX package used ``approx_max_k`` over a
  random permutation to dodge TPU bins).
"""
from __future__ import annotations

import torch

from . import nearest as _nearest


def _row_block(E: int, entries: int) -> int:
    """Query rows per block so that a [rows, E] buffer holds at most
    ``entries`` values, for any E."""
    return max(1, entries // max(E, 1))


def nearest_centroid(sources, queries, *, query_chunk: int = 262_144,
                     plain: bool = False):
    """Index of the (candidate-grade) nearest source per query, [N] int32
    (f64 ``sources`` [E, d] and ``queries`` [N, d] on one device).
    ``plain`` runs the kernel's plain twin instead of the kernel."""
    fn = _nearest.nearest_centroid_ref if plain else _nearest.nearest
    N = queries.shape[0]
    out = [fn(queries[s:s + query_chunk], sources)
           for s in range(0, N, query_chunk)]
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=queries.device)
    return torch.cat(out) if len(out) > 1 else out[0]


def knn(sources, queries, k: int):
    """Exact k nearest sources by f64 distance, ascending:
    (dist2 [N, k] f64, idx [N, k] int32).  With fewer than k sources the
    last column repeats, as in the JAX package."""
    E = sources.shape[0]
    k_eff = min(k, E)
    d2s, idxs = [], []
    step = _row_block(E, 1 << 25)  # [rows, E, d] f64 diffs: <= 0.8 GB
    for s in range(0, queries.shape[0], step):
        q = queries[s:s + step]
        d2 = ((q[:, None, :] - sources[None, :, :]) ** 2).sum(dim=-1)
        v, i = torch.topk(d2, k_eff, dim=1, largest=False, sorted=True)
        d2s.append(v)
        idxs.append(i.to(torch.int32))
    if not d2s:
        return (torch.zeros((0, k), dtype=torch.float64,
                            device=queries.device),
                torch.zeros((0, k), dtype=torch.int32,
                            device=queries.device))
    d2, idx = torch.cat(d2s), torch.cat(idxs)
    if k_eff < k:
        d2 = torch.cat([d2, d2[:, -1:].expand(-1, k - k_eff)], dim=1)
        idx = torch.cat([idx, idx[:, -1:].expand(-1, k - k_eff)], dim=1)
    return d2, idx


def centred_topk(sources_c32, queries, center, k: int):
    """k nearest of the f32 ``sources_c32`` (sources minus ``center``)
    for f64 ``queries``, ranked by |c|^2 - 2 q.c in f32: [N, k] int32,
    nearest first."""
    q32 = (queries - center).to(torch.float32)
    s_norm = (sources_c32 * sources_c32).sum(dim=-1)
    step = _row_block(sources_c32.shape[0], 1 << 26)  # f32: 256 MB
    out = []
    for s in range(0, q32.shape[0], step):
        score = s_norm[None, :] - 2.0 * (q32[s:s + step] @ sources_c32.T)
        out.append(torch.topk(score, k, dim=1, largest=False,
                              sorted=True).indices.to(torch.int32))
    if not out:
        return torch.zeros((0, k), dtype=torch.int32, device=queries.device)
    return torch.cat(out)
