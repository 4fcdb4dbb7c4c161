"""Point location: candidates -> Newton ladder -> accept -> fallbacks.

Counterpart of the JAX package's ``search/locate.py`` for the main path, the
escalation ladder of the JAX package's TPU engine, on sources of at most
16,384 elements:

1. round 1: every point's nearest centroid (K2, ``search.nearest``) and
   one Newton solve on it (K1, ``search.newton``);
2. rounds 2-3: the failures, hardest first, try the next columns of
   their top-8 nearest centroids;
3. round 4: an exact kNN with ``nelem_to_search`` candidates for the last
   C/128 failures;
4. the sentinel / snap / best fallbacks;
5. a scan retry (K1 once per candidate column) for unaccepted rows that
   never reached round 4.

Accept semantics are the reference's first-accept-in-distance-order and
best-so-far (reference multi_mesh/components/interpolator.py:1147-1255).
Sources of at most 64 elements take exact top-k candidates with
K = min(8, E) columns through the same rounds instead.

Outside this slice (each raises ``NotImplementedError`` naming its
ROADMAP item): the grid route for E > 16,384 (A6); ``fixed_ref``,
``use_aabb`` and the trilinear prefilter (A4); the f64 / df32 polish and
``Precision.F64`` (A7).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import DEFAULT_LOCATE, LocateConfig, Precision
from ..core import gll
from ..hashing import content_fingerprint
from . import knn as _knn
from . import newton as _newton

# residual threshold (unit-element frame) separating converged f32 Newton
# solves (~1e-6 plateau) from diverged/exterior junk
_F32_CONV_TOL = 1e-4
# largest source served by the exact round-4 search
# (APPROX_GRID_MIN_SOURCES of the JAX package's search/grid.py)
GRID_MIN_SOURCES = 16_384
# above this many sources round 1 takes the single nearest centroid
_NEAR1_MIN_SOURCES = 64
_FALLBACKS = ("sentinel", "snap", "best")


@dataclasses.dataclass
class LocateResult:
    """elements [N] int32 (-1 = not found), refs [N, d] f32, weights
    [N, (p+1)^d] f32 ([N, 0] without ``want_weights``), found [N] bool
    (True also for snapped / fallback assignments); all on the device of
    the call.  ``n_retry`` counts the rows the scan retry re-ran."""

    elements: torch.Tensor
    refs: torch.Tensor
    weights: torch.Tensor
    found: torch.Tensor
    n_retry: int = 0


@dataclasses.dataclass(frozen=True)
class _Prep:
    """Per-element geometry on the device (see ``_mesh_prep``)."""

    lo: torch.Tensor  # [E, d] f64 AABB
    hi: torch.Tensor  # [E, d] f64
    centroids: torch.Tensor  # [E, d] f64 node means
    ctr: torch.Tensor  # [E, d] f64 AABB centres
    inv_scale: torch.Tensor  # [E] f64, 1 / (half the largest extent)
    nodes: torch.Tensor  # [E, n*d] f32 unit-frame lattice


_PREP_CACHE: dict = {}


def _mesh_prep(elem_nodes: np.ndarray, order: int, device) -> _Prep:
    """Per-element geometry, computed in f64 on the host and cached by
    content fingerprint (a transfer makes many locate calls against one
    mesh)."""
    key = (content_fingerprint(elem_nodes), order, str(device))
    prep = _PREP_CACHE.get(key)
    if prep is None:
        if len(_PREP_CACHE) > 8:
            _PREP_CACHE.clear()
        E, n, d = elem_nodes.shape
        lo = elem_nodes.min(axis=1)
        hi = elem_nodes.max(axis=1)
        centers = 0.5 * (lo + hi)
        scales = np.maximum(0.5 * (hi - lo).max(axis=-1), 1e-30)
        nodes_c = (elem_nodes - centers[:, None, :]) / scales[:, None, None]

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=device)

        prep = _Prep(
            lo=dev(lo), hi=dev(hi), centroids=dev(elem_nodes.mean(axis=1)),
            ctr=dev(centers), inv_scale=dev(1.0 / scales),
            nodes=dev(nodes_c.astype(np.float32).reshape(E, n * d)),
        )
        _PREP_CACHE[key] = prep
    return prep


def _row_solver(prep: _Prep, order: int, d: int, cfg: LocateConfig,
                plain: bool):
    """solve(points [M, d] f64, ids [M] int32) -> (refs f32, res f32)
    through K1, or through its plain twin with ``plain``."""
    fn = _newton.newton_refs_rows_ref if plain else _newton.newton_rows
    iters = cfg.newton_iters + cfg.polish_iters

    def solve(points, ids):
        return fn(points.contiguous(), ids.contiguous(), prep.ctr,
                  prep.inv_scale, prep.nodes, order, d, iters,
                  cfg.newton_clamp)

    return solve


def _assemble(fallback, cfg, acc, acc_elem, acc_ref, best_max, best_ref,
              best_elem):
    """(elements, refs, found) under the fallback's failure semantics:
    sentinel -1 and zero refs (reference get_element_weights with
    snap_to_nearest=False, interpolator.py:1231-1233); snap to the best
    candidate with refs clipped to +/- snap_clip (interpolator.py:
    1217-1230); best-so-far unclipped if below fallback_max
    (trilinearinterpolator.c:113-137)."""
    if fallback == "sentinel":
        return (torch.where(acc, acc_elem, -1),
                torch.where(acc[:, None], acc_ref, 0.0), acc)
    if fallback == "snap":
        snapped = best_ref.clamp(-cfg.snap_clip, cfg.snap_clip)
        return (torch.where(acc, acc_elem, best_elem),
                torch.where(acc[:, None], acc_ref, snapped),
                torch.ones_like(acc))
    ok = best_max < cfg.fallback_max
    return (torch.where(acc, acc_elem, torch.where(ok, best_elem, -1)),
            torch.where(acc[:, None], acc_ref,
                        torch.where(ok[:, None], best_ref, 0.0)),
            acc | ok)


def _ladder_chunk(points, cand, solve, cfg, fallback, C, bucket_cands,
                  centroids, k_full):
    """The escalation ladder over one chunk.

    points [n, d] f64, cand [n, K] int32 (K = 1: nearest centroid, whose
    failures take ``bucket_cands(points) -> [B, 8]`` in rounds 2-3).
    ``C`` is the chunk's power-of-two row bucket: the rescue bucket sizes
    derive from it exactly as in the JAX package, so both evaluate the
    same rows in every round.  Returns (elements, refs, found,
    needs_retry)."""
    n, d = points.shape
    K = cand.shape[1]
    inf = float("inf")

    def eval_rows(pts, ids):
        ref, res = solve(pts, ids)
        conv = res < _F32_CONV_TOL
        maxabs = ref.abs().amax(dim=-1)
        accepted = conv & (maxabs < cfg.accept_tol)
        return ref, accepted, torch.where(conv, maxabs, inf)

    # ---- round 1: nearest candidate, all points -----------------------
    elem = cand[:, 0].contiguous()
    ref, acc, best_max = eval_rows(points, elem)
    best_ref, best_elem = ref.clone(), elem.clone()

    def rescue(cols, idx):
        """Retry rows ``idx`` on candidate columns ``cols`` [B, r]:
        first accepting column wins, best score updates best-so-far.
        Rows already accepted are left untouched.  ``idx`` is unique, so
        the indexed assignments below are plain scatters."""
        B, r = cols.shape
        if B == 0 or r == 0:
            return
        ids_r = cols.T.contiguous()  # [r, B]
        refs_f, acc_f, score_f = eval_rows(points[idx].repeat(r, 1),
                                           ids_r.reshape(-1))
        refs_r = refs_f.view(r, B, d)
        acc_r = acc_f.view(r, B)
        score_r = score_f.view(r, B)
        was = acc[idx]
        fi = acc_r.to(torch.uint8).argmax(dim=0, keepdim=True)  # first
        any_acc = acc_r.any(dim=0) & ~was
        sel_ref = refs_r.gather(0, fi[..., None].expand(1, B, d))[0]
        sel_elem = ids_r.gather(0, fi)[0]
        bi = score_r.argmin(dim=0, keepdim=True)
        b_score = score_r.gather(0, bi)[0]
        b_ref = refs_r.gather(0, bi[..., None].expand(1, B, d))[0]
        b_elem = ids_r.gather(0, bi)[0]
        elem[idx] = torch.where(any_acc, sel_elem, elem[idx])
        ref[idx] = torch.where(any_acc[:, None], sel_ref, ref[idx])
        acc[idx] = any_acc | was
        better = (b_score < best_max[idx]) & ~was
        best_max[idx] = torch.where(better, b_score, best_max[idx])
        best_ref[idx] = torch.where(better[:, None], b_ref, best_ref[idx])
        best_elem[idx] = torch.where(better, b_elem, best_elem[idx])

    def failure_order(B):
        """The B hardest-to-dismiss failures: unaccepted rows by their
        best max |ref| so far (near-boundary interior stragglers first),
        diverged rows next, accepted rows last.  Stable, as jnp.argsort:
        ties keep row order."""
        key = torch.where(
            acc, inf, torch.where(torch.isfinite(best_max), best_max, 1.5))
        return torch.argsort(key, stable=True)[:B]

    # ---- rounds 2-3: the next candidate columns ------------------------
    if K > 1:
        idx = failure_order(max(C // 4, min(C, 256)))
        rescue(cand[idx][:, 1:min(4, K)], idx)
        if K > 4:
            idx = failure_order(max(C // 8, min(C, 256)))
            rescue(cand[idx][:, 4:min(12, K)], idx)
    elif bucket_cands is not None:
        idx = failure_order(max(C // 4, min(C, 256)))
        cand_b = bucket_cands(points[idx])
        kk = cand_b.shape[1]
        # round 3 reads the parked top-k; a row that enters round 3
        # without a round-2 slot reads zeros and evaluates element 0
        # harmlessly (as in the JAX package), keeping its full-recall
        # shot in round 4 / the scan retry
        parked = torch.zeros((n, kk), dtype=torch.int32,
                             device=points.device)
        parked[idx] = cand_b
        rescue(cand_b[:, 1:min(4, kk)], idx)
        if kk > 4:
            idx = failure_order(max(C // 32, min(C, 256)))
            rescue(parked[idx][:, 4:kk], idx)
    # ---- round 4: exact re-search for the hardest failures -------------
    idx = failure_order(max(C // 128, min(C, 128)))
    rescue(_knn.knn(centroids, points[idx], k_full)[1], idx)
    full_op = torch.zeros((n,), dtype=torch.bool, device=points.device)
    full_op[idx] = True

    elements, refs, found = _assemble(fallback, cfg, acc, elem, ref,
                                      best_max, best_ref, best_elem)
    return elements, refs, found, ~acc & ~full_op


def _scan_candidates(points, cand, solve, cfg, fallback):
    """Exhaustive scan of all K candidate columns in distance order,
    carrying first-accepted and best-so-far state per point (the JAX
    package's _scan_candidates + _locate_chunk without the AABB and
    prefilter state of A4).  Returns (elements, refs, found)."""
    n, d = points.shape
    acc = torch.zeros((n,), dtype=torch.bool, device=points.device)
    acc_ref = torch.zeros((n, d), dtype=torch.float32, device=points.device)
    acc_elem = cand[:, 0].contiguous()
    best_max = torch.full((n,), float("inf"), device=points.device)
    best_ref = acc_ref.clone()
    best_elem = acc_elem.clone()
    for k in range(cand.shape[1]):
        ids = cand[:, k].contiguous()
        ref, res = solve(points, ids)
        conv = res < _F32_CONV_TOL
        maxabs = ref.abs().amax(dim=-1)
        accepted = conv & (maxabs < cfg.accept_tol)
        newly = accepted & ~acc
        acc_ref = torch.where(newly[:, None], ref, acc_ref)
        acc_elem = torch.where(newly, ids, acc_elem)
        acc = acc | accepted
        score = torch.where(conv, maxabs, float("inf"))
        better = score < best_max
        best_max = torch.where(better, score, best_max)
        best_ref = torch.where(better[:, None], ref, best_ref)
        best_elem = torch.where(better, ids, best_elem)
    return _assemble(fallback, cfg, acc, acc_elem, acc_ref, best_max,
                     best_ref, best_elem)


def _check_scope(E, cfg, fallback, use_aabb, prefilter_m):
    if fallback == "fixed_ref" or use_aabb or prefilter_m > 0:
        raise NotImplementedError(
            "fixed_ref, use_aabb and the trilinear prefilter are not "
            "ported yet (ROADMAP A4)")
    if fallback not in _FALLBACKS:
        raise ValueError(f"unknown fallback mode {fallback!r}")
    if cfg.f64_polish or cfg.df32_polish or cfg.precision == Precision.F64:
        raise NotImplementedError(
            "the f64 / df32 polish and Precision.F64 are not ported yet "
            "(ROADMAP A7)")
    if E > GRID_MIN_SOURCES:
        raise NotImplementedError(
            f"sources of more than {GRID_MIN_SOURCES} elements take the "
            f"grid route, not ported yet (ROADMAP A6); got {E}")


def locate(points, elem_nodes, order: int,
           cfg: LocateConfig = DEFAULT_LOCATE, *, fallback: str = "sentinel",
           use_aabb: bool = False, prefilter_m: int = 0,
           chunk: int = 262_144, want_weights: bool = True,
           device="cuda", plain: bool = False) -> LocateResult:
    """Locate each query point in the source mesh.

    points [N, d] (numpy or tensor; moved to ``device`` as f64);
    elem_nodes [E, (p+1)^d, d] (numpy or tensor; prepared on the host in
    f64, see ``_mesh_prep``).  ``fallback`` in {"sentinel", "snap",
    "best"}.  On a CUDA device the Newton solves and the round-1 search
    run the hand-written kernels; on the CPU, their plain twins.
    ``plain=True`` runs the plain twins on any device (to check the
    kernels against them).
    """
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"locate: unsupported device {device}")
    if isinstance(elem_nodes, torch.Tensor):
        elem_nodes = elem_nodes.detach().cpu().numpy()
    elem_nodes = np.asarray(elem_nodes, dtype=np.float64)
    E, _, d = elem_nodes.shape
    _check_scope(E, cfg, fallback, use_aabb, prefilter_m)
    points = torch.as_tensor(points, dtype=torch.float64, device=device)
    N = points.shape[0]
    prep = _mesh_prep(elem_nodes, order, device)
    solve = _row_solver(prep, order, d, cfg, plain)
    k_full = min(cfg.nelem_to_search, E)
    near1 = E > _NEAR1_MIN_SOURCES
    bucket_cands = None
    if near1:
        center = prep.centroids.mean(dim=0)
        sources_c32 = (prep.centroids - center).to(torch.float32)

        def bucket_cands(q):
            return _knn.centred_topk(sources_c32, q, center, min(8, E))

    outs = []
    for s in range(0, N, chunk):
        pts_c = points[s:s + chunk]
        n = pts_c.shape[0]
        if near1:
            cand = _knn.nearest_centroid(prep.centroids, pts_c,
                                         plain=plain)[:, None]
        else:
            cand = _knn.knn(prep.centroids, pts_c, min(k_full, 8))[1]
        C = 1 << max(0, n - 1).bit_length()
        outs.append(_ladder_chunk(pts_c, cand, solve, cfg, fallback, C,
                                  bucket_cands, prep.centroids, k_full))
    if outs:
        elements, refs, found, needs_retry = (torch.cat(c) for c in
                                              zip(*outs))
    else:
        elements = torch.zeros((0,), dtype=torch.int32, device=device)
        refs = torch.zeros((0, d), dtype=torch.float32, device=device)
        found = needs_retry = torch.zeros((0,), dtype=torch.bool,
                                          device=device)

    if fallback == "sentinel" and N:
        # A point outside the global source AABB (with a halo covering
        # accept_tol's reach past the hull) is inside no element: its
        # sentinel result is already exact, so it skips the retry.
        # Snap/best results depend on the best-so-far over all
        # candidates, so those retry every crowded-out row.
        glo = prep.lo.amin(dim=0)
        ghi = prep.hi.amax(dim=0)
        elem_ext = (prep.hi - prep.lo).amax(dim=0)
        eps = (cfg.accept_tol - 1.0) * elem_ext + 1e-5 * (ghi - glo)
        needs_retry &= ((points >= glo - eps)
                        & (points <= ghi + eps)).all(dim=-1)
    retry = torch.nonzero(needs_retry).squeeze(1)
    n_retry = int(retry.shape[0])
    # Crowded-out rows: unaccepted points that never reached round 4 go
    # through the exhaustive scan with fresh exact candidates, so the
    # ladder degrades to the scan's semantics, never to a silent
    # fallback on an interior point.  Chunked like the main loop.
    for rs in range(0, n_retry, chunk):
        rows = retry[rs:rs + chunk]
        pts_r = points[rows]
        cand_r = _knn.knn(prep.centroids, pts_r, k_full)[1]
        r_el, r_ref, r_found = _scan_candidates(pts_r, cand_r, solve, cfg,
                                                fallback)
        elements[rows] = r_el
        refs[rows] = r_ref
        found[rows] = r_found

    if want_weights:
        weights = torch.where(found[:, None],
                              gll.tensor_basis(order, refs), 0.0)
    else:
        weights = torch.zeros((N, 0), dtype=torch.float32, device=device)
    return LocateResult(elements, refs, weights, found, n_retry)
