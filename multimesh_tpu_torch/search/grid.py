"""Cell-binned two-level candidate search for large source meshes.

Counterpart of the JAX package's ``search/grid.py``.  The exact kNN
(``search.knn.knn``) computes all N x E distances; beyond ~100k source
elements that term dominates a transfer.  Here the element centroids are
partitioned into balanced bins, queries rank the bins by the distance to
their representatives with one much smaller matrix product, and the
candidates come from the members of the ``n_probe`` nearest bins.

Binning is a median-split tree (recursively halve the widest axis until a
bin holds at most ``target_per_cell`` members), not a uniform grid:
element sizes of seismic meshes vary by orders of magnitude between crust
and core, which leaves a uniform grid's occupancy unbounded, while median
splits bound it by construction.  ``build_grid`` is the JAX package's
host code, so both packages bin a mesh identically.

What differs from the JAX package is the TPU's own: the card has native
f64, so member coordinates are stored centred once in f32 (ranking: the
ladder's round 1 and its in-ladder probes) and once in f64 (the distances
``grid_knn`` returns) instead of as split-f32 pairs; selection is exact
(``torch.topk`` / ``argmin``) where the TPU path used ``approx_max_k``;
and queries run in row blocks sized to bound the [rows, n_bins] score
and the [rows, p, d, m] member gather, not in power-of-two buckets.  The
search is stock PyTorch: the JAX route is plain XLA, with no Pallas
kernel behind it.

Recall: with ``n_probe`` bins per query the true nearest elements of
well-shaped meshes are covered; the locate ladder adds a safety net (its
rescue rounds probe more bins for every point whose candidates all fail).
For guaranteed-exact search use ``search.knn.knn``; ``knn_any``
dispatches on the source count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..hashing import array_fingerprint
from ..utils_profile import stage_timer
from . import knn as _knn

# Sources up to this count take the exact kNN on the exact route.
EXACT_KNN_MAX_SOURCES = 131_072
# On the locate ladder (whose rescue rounds restore recall) the grid takes
# over much earlier: its cost per point does not grow with E.
APPROX_GRID_MIN_SOURCES = 16_384
# coordinate of a padding slot: never ranks (its square stays finite in f32)
_PAD = 1e15
# entries of a [rows, n_bins] score block and of a [rows, p, d, m] member
# gather (each has two temporaries of its size beside it)
_BLOCK_ENTRIES = 1 << 27


@dataclasses.dataclass
class GridIndex:
    """Balanced bin -> element lists with planar member coordinates.

    bin_reps32   [n_bins, d] f32    centred representative of each bin
    rep_norm     [n_bins] f32       its squared norm
    center       [d] f64            the centring offset
    bin_elems    [n_bins, m] int32  member element ids (padding repeats
                                    slot 0)
    bin_coords32 [n_bins, d, m] f32 centred member coordinates, planar
                                    (member slot innermost; padding slots
                                    hold 1e15)
    bin_coords64 [n_bins, d, m] f64 the same in f64
    bin_counts   [n_bins] int32     true member count of each bin (host)

    ``bin_counts`` is numpy; every tensor is on the device of the build.
    """

    bin_reps32: torch.Tensor
    rep_norm: torch.Tensor
    center: torch.Tensor
    bin_elems: torch.Tensor
    bin_coords32: torch.Tensor
    bin_coords64: torch.Tensor
    bin_counts: np.ndarray

    @property
    def n_bins(self) -> int:
        return self.bin_reps32.shape[0]

    @property
    def members_per_bin(self) -> int:
        return self.bin_elems.shape[1]


def _median_split(cents: np.ndarray, target_per_cell: int):
    """The bins (index arrays) of the median-split tree, in DFS order."""
    bins: list[np.ndarray] = []
    stack = [np.arange(cents.shape[0])]
    while stack:
        idx = stack.pop()
        if len(idx) <= target_per_cell:
            bins.append(idx)
            continue
        pts = cents[idx]
        axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
        half = len(idx) // 2
        part = np.argpartition(pts[:, axis], half)  # O(n) median split
        stack.append(idx[part[:half]])
        stack.append(idx[part[half:]])
    return bins


def build_grid(centroids, target_per_cell: int = 128,
               device="cuda") -> GridIndex:
    """Median-split balanced binning of ``centroids`` [E, d] (host numpy,
    one-time, O(E log E)), with the index tensors put on ``device``."""
    cents = np.asarray(centroids, np.float64)
    d = cents.shape[1]
    bins = _median_split(cents, target_per_cell)
    n_bins, m = len(bins), target_per_cell
    center = cents.mean(axis=0)
    cents_c = cents - center
    cents_c32 = cents_c.astype(np.float32)

    elems = np.zeros((n_bins, m), np.int32)
    coords64 = np.full((n_bins, d, m), _PAD, np.float64)
    counts = np.zeros(n_bins, np.int32)
    reps = np.zeros((n_bins, d), np.float32)
    for i, b in enumerate(bins):
        c = len(b)
        elems[i, :c] = b
        elems[i, c:] = b[0] if c else 0
        counts[i] = c
        coords64[i, :, :c] = cents_c[b].T
        reps[i] = cents_c32[b].mean(axis=0)

    def dev(a):
        return torch.as_tensor(a, device=device)

    reps_d = dev(reps)
    return GridIndex(
        bin_reps32=reps_d, rep_norm=(reps_d * reps_d).sum(dim=-1),
        center=dev(center), bin_elems=dev(elems),
        bin_coords32=dev(coords64.astype(np.float32)),
        bin_coords64=dev(coords64), bin_counts=counts,
    )


_INDEX_CACHE: dict = {}


def get_grid_index(sources, target_per_cell: int = 128,
                   device="cuda") -> GridIndex:
    """The cached balanced-bin index of the host array ``sources`` [E, d]
    on ``device``, keyed by the array's content fingerprint (see
    ``hashing.array_fingerprint``: a read-only array is hashed once),
    ``target_per_cell`` and the device."""
    sources = np.asarray(sources)
    key = (array_fingerprint(sources), sources.shape, target_per_cell,
           str(torch.device(device)))
    index = _INDEX_CACHE.get(key)
    if index is None:
        if len(_INDEX_CACHE) > 16:
            _INDEX_CACHE.clear()
        index = build_grid(sources, target_per_cell, device)
        _INDEX_CACHE[key] = index
    return index


def spatial_order(sources) -> np.ndarray:
    """Permutation [E] int64 placing spatially adjacent sources at
    adjacent indices: the members of the median-split bins of 32 in the
    tree's DFS order, which walks the domain like a space-filling curve
    (host numpy; the JAX package's permutation)."""
    cents = np.asarray(sources, np.float64)
    return np.concatenate(_median_split(cents, 32)).astype(np.int64)


def _row_step(n_bins: int, p: int, d: int, m: int) -> int:
    """Query rows per block, so that neither the [rows, n_bins] score of
    stage 1 nor the [rows, p, d, m] member gather of stage 2 exceeds
    ``_BLOCK_ENTRIES`` (at 3,900 bins, one 262,144-query chunk would score
    4.1 GB in f32 and gather 1.6 GB at p = 4, m = 128)."""
    return min(_knn._row_block(n_bins, _BLOCK_ENTRIES),
               _knn._row_block(p * d * m, _BLOCK_ENTRIES))


def _probe_bins(index: GridIndex, q_c, p: int):
    """Stage 1: the ``p`` bins whose representatives lie nearest to the
    centred f64 queries ``q_c``, by |rep|^2 - 2 q.rep in f32 (one small
    matrix product): [rows, p] int64."""
    score = torch.addmm(index.rep_norm, q_c.to(torch.float32),
                        index.bin_reps32.T, alpha=-2.0)  # one pass
    return torch.topk(score, p, dim=1, largest=False).indices


def _rank_members(index: GridIndex, probe, q_c, k: int, coords):
    """Stage 2: every member of the probed bins scored in one shot, in the
    dtype of ``coords`` (whole-bin planar rows keep the gather
    contiguous), and the ``k`` nearest selected: (dist2 [rows, k]
    ascending, idx [rows, k] int32)."""
    rows, p = probe.shape
    m = coords.shape[2]
    diff = coords[probe].sub_(q_c.to(coords.dtype)[:, None, :, None])
    d2 = diff.mul_(diff).sum(dim=2).view(rows, p * m)
    del diff
    if k == 1:
        pos = d2.argmin(dim=1, keepdim=True)  # ties: the first slot
        val = d2.gather(1, pos)
    else:
        val, pos = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return val, index.bin_elems[probe].view(rows, p * m).gather(1, pos)


def _grid_query(index: GridIndex, queries, k: int, n_probe: int, coords):
    """The two-level search: the ``k`` nearest members of the ``n_probe``
    rep-nearest bins of each query, ranked by their squared distance in
    the dtype of ``coords`` (``index.bin_coords32`` or ``bin_coords64``).
    Returns (dist2 [N, k] in that dtype, ascending; idx [N, k] int32).
    With fewer than k probed slots the last column repeats."""
    n_bins, d, m = coords.shape
    p = min(n_probe, n_bins)
    k_eff = min(k, p * m)
    step = _row_step(n_bins, p, d, m)
    starts = range(0, queries.shape[0], step)
    # each stage over all row blocks in turn, so each is one span a call
    with stage_timer("grid.probe_bins"):
        probes = [_probe_bins(index, queries[s:s + step] - index.center, p)
                  for s in starts]
    d2s, idxs = [], []
    with stage_timer("grid.rank_members"):
        for s, probe in zip(starts, probes):
            val, idx = _rank_members(index, probe,
                                     queries[s:s + step] - index.center,
                                     k_eff, coords)
            d2s.append(val)
            idxs.append(idx)
    del probes
    if not d2s:
        return (torch.zeros((0, k), dtype=coords.dtype,
                            device=queries.device),
                torch.zeros((0, k), dtype=torch.int32,
                            device=queries.device))
    d2, idx = torch.cat(d2s), torch.cat(idxs)
    if k_eff < k:
        d2 = torch.cat([d2, d2[:, -1:].expand(-1, k - k_eff)], dim=1)
        idx = torch.cat([idx, idx[:, -1:].expand(-1, k - k_eff)], dim=1)
    return d2, idx


def nearest_member(index: GridIndex, queries, *, n_probe: int = 4):
    """Index of the (approximately) nearest binned source per query, [N]
    int32: exact (in f32) within the ``n_probe`` rep-nearest bins; a query
    whose true nearest member lies outside them gets those bins' best, so
    callers pair this with a rescue path, as the locate ladder does.
    Probing fewer than 4 bins loses adjacent-bin recall that the ladder
    does not fully recover under snap semantics (end-to-end error ~1e-3
    in the JAX package's measurements)."""
    return _grid_query(index, queries, 1, n_probe, index.bin_coords32)[1][:, 0]


def probe_topk(index: GridIndex, queries, k: int, n_probe: int):
    """The ``k`` nearest members of the ``n_probe`` rep-nearest bins per
    query, ranked in f32: [N, k] int32, nearest first (the ladder's rescue
    rounds, which only need candidates in order)."""
    return _grid_query(index, queries, k, n_probe, index.bin_coords32)[1]


def grid_knn(index: GridIndex, queries, k: int, *, n_probe: int = 8):
    """k nearest binned sources per query via the two-level search, by
    f64 distance: (dist2 [N, k] f64 ascending, idx [N, k] int32)."""
    return _grid_query(index, queries, k, n_probe, index.bin_coords64)


def knn_any(sources, queries, k: int, *, sources_host=None,
            n_probe: int = 8):
    """Candidate search dispatcher: (dist2 [N, k] f64, idx [N, k] int32).

    ``sources`` [E, d] and ``queries`` [N, d] are f64 tensors on one
    device.  Up to ``EXACT_KNN_MAX_SOURCES`` sources the exact
    ``knn.knn`` runs; beyond, the balanced-bin search with exact selection
    over the members of ``n_probe`` bins.  The grid index is cached by the content of the
    sources; ``sources_host``, the same values as a host array, spares
    copying them back (and, read-only, hashing them) on every call."""
    E = sources.shape[0]
    if E <= EXACT_KNN_MAX_SOURCES:
        return _knn.knn(sources, queries, k)
    if sources_host is None:
        sources_host = sources.detach().cpu().numpy()
    index = get_grid_index(sources_host, 128, queries.device)
    return grid_knn(index, queries, k, n_probe=n_probe)
