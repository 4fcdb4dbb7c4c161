"""Point location: candidates -> Newton -> accept -> fallbacks -> polish.

Counterpart of the JAX package's ``search/locate.py`` on sources of any
size, along the routes of its TPU engine.

``strategy="ladder"`` (and "auto"), the escalation ladder, for sources
of at most ``grid.APPROX_GRID_MIN_SOURCES`` (16,384) elements:

1. round 1: every point's nearest centroid (K2, ``search.nearest``) and
   one Newton solve on it (K1, ``search.newton``);
2. rounds 2-3: the failures, hardest first, try the next columns of
   their top-8 nearest centroids;
3. round 4: an exact kNN with ``nelem_to_search`` candidates for the
   hardest failures;

and for larger sources, where a [rows, E] sweep would grow with the mesh,
the same rounds over the balanced-bin index of ``search.grid`` (the grid
route): round 1 takes the nearest member of the 4 nearest 128-member
bins, rounds 2-3 the top 12 of 2 probed bins, round 4 the full
``nelem_to_search`` list of 16 probed bins.  The rescue rounds are sized
by round 1's failures, capped at fixed buckets of the chunk (C/4, C/32,
C/128 rows of a chunk of C on the nearest-centroid route, C/32 each on
the grid route): a chunk that round 1 accepts whole skips them.  Then, on both
routes:

4. the sentinel / snap / best / fixed_ref fallbacks;
5. a scan retry (K1 once per candidate column) of the unaccepted rows
   that never reached round 4 -- under ``fixed_ref`` of every unaccepted
   row, since its fallback needs the scan's per-candidate AABB and
   nearest-centre state;
6. on request, a polish of the accepted rows: ``LocateConfig.f64_polish``
   (two f64 Newton steps in plain torch, f64 refs) or ``df32_polish``
   (K4, ``search.polish``; the refs become an (f32, f32) pair that the
   transfer operator applies through K5).  ``Precision.F64`` is served
   as ``f64_polish``: acceptance is decided in f32 by the kernels, then
   every accepted row is polished in f64 and the refs and weights come
   back f64, on both strategies and both devices.  (On the JAX package's
   CPU engine F64 runs every Newton step in f64; on its accelerator
   engine it changes only the xla engine's dtype.)

``strategy="scan"``: kNN candidates (``grid.knn_any``: exact up to
131,072 elements, 8 probed bins beyond), ranked down to ``prefilter_m``
by the trilinear prefilter (K1 at order 1 on the element corners, the
JAX package's order-1 use of K3) and scanned in distance order; the rows
that the prefiltered list fails to accept are scanned again with the
full list.  The ladder accepts ``prefilter_m`` and ignores it, as the
JAX package does.

Accept semantics are the reference's first-accept-in-distance-order and
best-so-far (reference multi_mesh/components/interpolator.py:1147-1255);
``use_aabb`` also requires the point inside the candidate's bounding box.
Sources of at most 64 elements take exact top-k candidates with
K = min(8, E) columns through the same rounds instead.

``candidates`` [N, K] (ids into ``elem_nodes``, e.g. from a per-layer
search of the caller's) replace the internal search: on the ladder they
are round 1's column and the columns of rounds 2-3, and the scan retry
scans them again (round 4 still searches by centroid with the full
budget); on the scan they are the list to scan.  ``centroids`` [E, d]
replace the mesh's own node means in every search and as the grid
index's key, never in the geometry (AABBs, unit frames).

The chunk loop and the scan retry report progress ("locate", "locate
retry"; ``progress.progress``, off unless enabled), waiting for the
device about every 5% of the chunks only when it is on.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

from ..config import (DEFAULT_LOCATE, FALLBACK_REF_COORD, LocateConfig,
                      Precision)
from ..core import gll, shape
from ..hashing import array_fingerprint
from ..progress import progress as _progress
from ..utils_profile import count, stage_timer
from . import grid as _grid
from . import knn as _knn
from . import newton as _newton
from . import polish as _polish

# residual threshold (unit-element frame) separating converged f32 Newton
# solves (~1e-6 plateau) from diverged/exterior junk
_F32_CONV_TOL = 1e-4
# The grid route's round 1: members per bin of its index and bins probed.
# Stage 1's [C, n_bins] score block is the larger traffic, so fewer,
# larger bins beat a smaller member gather; probing fewer than 4 bins
# loses adjacent-bin recall that the rescue rounds do not fully recover
# under snap semantics (see ``grid.nearest_member``).
ROUND1_MEMBERS = 128
ROUND1_PROBES = 4
# above this many sources round 1 takes the single nearest centroid
_NEAR1_MIN_SOURCES = 64
_FALLBACKS = ("sentinel", "snap", "best", "fixed_ref")
_STRATEGIES = ("auto", "ladder", "scan")
# f64 Newton steps of f64_polish: quadratic convergence takes the ~1e-7
# f32 refs below 1e-12 in two (the JAX package's locate.py:697-700)
_F64_POLISH_ITERS = 2
# AABB test slack relative to the element's extent, for f64 points (the
# JAX package's f64 branch, locate.py:445-453): face points must never be
# excluded by rounding
_AABB_RTOL = 1e-9


@dataclasses.dataclass
class LocateResult:
    """elements [N] int32 (-1 = not found), refs [N, d] f32 (f64 after
    ``f64_polish``), weights [N, (p+1)^d] in the refs' dtype ([N, 0]
    without ``want_weights``), found [N] bool (True also for snapped /
    fallback assignments), accepted [N] bool (a candidate passed the
    accept test, in the ladder, the scan or a retry); all on the device
    of the call.  After ``df32_polish``, ``refs + refs_lo`` ([N, d] f32
    each) is the pair-precision ref, with ``refs_lo`` zero on rows the
    polish left alone.  ``n_retry`` counts the rows the scan retry
    re-ran."""

    elements: torch.Tensor
    refs: torch.Tensor
    weights: torch.Tensor
    found: torch.Tensor
    accepted: torch.Tensor
    refs_lo: torch.Tensor | None = None
    n_retry: int = 0


@dataclasses.dataclass
class _Prep:
    """Per-element geometry on the device (see ``_mesh_prep``)."""

    lo: torch.Tensor  # [E, d] f64 AABB
    hi: torch.Tensor  # [E, d] f64
    centroids: torch.Tensor  # [E, d] f64 node means
    centroids_host: np.ndarray  # the same on the host, read-only
    ctr: torch.Tensor  # [E, d] f64 AABB centres
    inv_scale: torch.Tensor  # [E] f64, 1 / (half the largest extent)
    nodes: torch.Tensor  # [E, n*d] f32 unit-frame lattice
    corners: torch.Tensor  # [E, 2^d*d] f32 unit-frame corner nodes
    # [E, n*d] f64 lattice, attached when a polish first asks for it
    nodes64: torch.Tensor | None = None


_PREP_CACHE: dict = {}


def _upload(elem_nodes: np.ndarray, device) -> torch.Tensor:
    with warnings.catch_warnings():
        # a frozen lattice: it is only read
        warnings.filterwarnings("ignore", message=".*not writable")
        return torch.as_tensor(np.ascontiguousarray(elem_nodes),
                               device=device)


def _unit_frame(x, lo, hi):
    """(AABB centres, half the largest extents, the lattice ``x`` in its
    elements' unit frames; f64)."""
    centers = 0.5 * (lo + hi)
    scales = (0.5 * (hi - lo).amax(dim=-1)).clamp_min(1e-30)
    nodes_c = x - centers[:, None, :]
    nodes_c /= scales[:, None, None]
    return centers, scales, nodes_c


def _mesh_prep(elem_nodes: np.ndarray, order: int, device,
               want64: bool = False) -> _Prep:
    """Per-element geometry, computed in f64 on ``device`` from the host
    lattice and cached by content fingerprint (a transfer makes many
    locate calls against one mesh; a read-only lattice is hashed once,
    see ``hashing.array_fingerprint``).  The arithmetic is elementwise
    but for the centroid mean, so it rounds as the host's would; at
    500,000 elements of order 4 the f64 lattice is 1.5 GB, which the card
    reduces in milliseconds.  ``want64`` also keeps the f64 unit-frame
    lattice on the device, which only the polish reads: the one cached
    prep of a mesh gains it when a polish first asks."""
    key = (array_fingerprint(elem_nodes), order, str(device))
    prep = _PREP_CACHE.get(key)
    E, n, d = elem_nodes.shape
    if prep is None:
        if len(_PREP_CACHE) > 8:
            _PREP_CACHE.clear()
        x = _upload(elem_nodes, device)
        lo, hi = x.amin(dim=1), x.amax(dim=1)
        centroids = x.mean(dim=1)
        centers, scales, nodes_c = _unit_frame(x, lo, hi)
        del x
        corners = nodes_c[:, torch.as_tensor(gll.corner_indices(order, d),
                                             device=device)]
        centroids_host = centroids.cpu().numpy()
        centroids_host.setflags(write=False)
        prep = _Prep(
            lo=lo, hi=hi, centroids=centroids,
            centroids_host=centroids_host, ctr=centers,
            inv_scale=1.0 / scales,
            nodes=nodes_c.to(torch.float32).view(E, n * d),
            corners=corners.to(torch.float32).reshape(E, -1),
            nodes64=nodes_c.view(E, n * d) if want64 else None,
        )
        _PREP_CACHE[key] = prep
    elif want64 and prep.nodes64 is None:
        prep.nodes64 = _unit_frame(_upload(elem_nodes, device), prep.lo,
                                   prep.hi)[2].view(E, n * d)
    return prep


def _row_solver(prep: _Prep, nodes, order: int, d: int, iters: int,
                clamp: float, plain: bool):
    """solve(points [M, d] f64, ids [M] int32) -> (refs f32, res f32):
    ``iters`` Newton steps on the unit-frame lattice ``nodes`` (the
    elements', or their corners' at order 1) through K1, or through its
    plain twin with ``plain``."""
    fn = _newton.newton_refs_rows_ref if plain else _newton.newton_rows

    def solve(points, ids):
        return fn(points.contiguous(), ids.contiguous(), prep.ctr,
                  prep.inv_scale, nodes, order, d, iters, clamp)

    return solve


def _make_eval(solve, prep: _Prep, cfg: LocateConfig, use_aabb: bool):
    """evaluate(points, ids) -> (ref, conv, maxabs, inside, accepted) for
    (point, element) rows; ``inside`` (the point in the element's AABB)
    is None without ``use_aabb``."""

    def evaluate(points, ids):
        ref, res = solve(points, ids)
        conv = res < _F32_CONV_TOL
        maxabs = ref.abs().amax(dim=-1)
        accepted = conv & (maxabs < cfg.accept_tol)
        inside = None
        if use_aabb:
            lo, hi = prep.lo[ids.long()], prep.hi[ids.long()]
            eps = _AABB_RTOL * (hi - lo)
            inside = ((points >= lo - eps) & (points <= hi + eps)).all(dim=-1)
            accepted &= inside
        return ref, conv, maxabs, inside, accepted

    return evaluate


def _fixed_ref(n: int, d: int, device) -> torch.Tensor:
    """[n, d] copies of the reference's fixed interior ref coordinate."""
    return torch.tensor(FALLBACK_REF_COORD[:d], dtype=torch.float32,
                        device=device).expand(n, d)


def _assemble(fallback, cfg, acc, acc_elem, acc_ref, best_max, best_ref,
              best_elem, fb=None):
    """(elements, refs, found) under the fallback's failure semantics:
    sentinel -1 and zero refs (reference get_element_weights with
    snap_to_nearest=False, interpolator.py:1231-1233); snap to the best
    candidate with refs clipped to +/- snap_clip (interpolator.py:
    1217-1230); best-so-far unclipped if below fallback_max
    (trilinearinterpolator.c:113-137); fixed_ref takes ``fb`` = (element,
    ref) of the reference's fallback choice (interpolator.py:1448-1473)."""
    if fallback == "sentinel":
        return (torch.where(acc, acc_elem, -1),
                torch.where(acc[:, None], acc_ref, 0.0), acc)
    if fallback == "snap":
        snapped = best_ref.clamp(-cfg.snap_clip, cfg.snap_clip)
        return (torch.where(acc, acc_elem, best_elem),
                torch.where(acc[:, None], acc_ref, snapped),
                torch.ones_like(acc))
    if fallback == "fixed_ref":
        fb_elem, fb_ref = fb
        return (torch.where(acc, acc_elem, fb_elem),
                torch.where(acc[:, None], acc_ref, fb_ref),
                torch.ones_like(acc))
    ok = best_max < cfg.fallback_max
    return (torch.where(acc, acc_elem, torch.where(ok, best_elem, -1)),
            torch.where(acc[:, None], acc_ref,
                        torch.where(ok[:, None], best_ref, 0.0)),
            acc | ok)


@dataclasses.dataclass(frozen=True)
class _Rescue:
    """What the ladder's rescue rounds search with, per route.

    ``bucket_cands(points) -> [B, kk]`` int32 gives rounds 2-3 their
    candidates when round 1 had one (None below ``_NEAR1_MIN_SOURCES``
    and for the caller's ``candidates``, where round 1's own columns
    serve); ``round4(points) -> [B, k]`` the full-budget list.  ``div``
    = (div2, div3, div4) caps the rounds of a chunk of C rows (``caps``).
    """

    bucket_cands: Callable | None
    round4: Callable
    div: tuple[int, int, int]

    def caps(self, C: int) -> tuple[int, int, int]:
        """The most rows rounds 2, 3 and 4 retry in a chunk whose
        power-of-two row bucket is C: C // div_r, and at least
        min(C, 256) in rounds 2-3, min(C, 128) in round 4."""
        d2, d3, d4 = self.div
        return (max(C // d2, min(C, 256)), max(C // d3, min(C, 256)),
                max(C // d4, min(C, 128)))


def _rescue_rows(B: int, n_unaccepted: int) -> int:
    """Rows a rescue round capped at ``B`` retries: the chunk's rows that
    round 1 left unaccepted, at most ``B``.  Their count only falls after
    round 1, and the rows past them in the failure order are accepted
    ones, which no round changes."""
    return min(B, n_unaccepted)


def _eval_rows(evaluate, pts, ids):
    """(refs, accepted, score) of (point, element) rows: the score is a
    converged solve's max |ref|, inf for a diverged one."""
    ref, conv, maxabs, _, accepted = evaluate(pts, ids)
    return ref, accepted, torch.where(conv, maxabs, float("inf"))


def _count_on_host(x):
    """Start copying the 0-d count ``x`` to the host: returns ``read() ->
    int``, which waits for that copy alone.  On the card it lands in
    pinned memory behind an event, so the work queued after it keeps the
    card busy while the host waits."""
    host, landed = x, None
    if x.is_cuda:
        host = torch.empty((), dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        landed = torch.cuda.Event()
        landed.record()

    def read():
        if landed is not None:
            landed.synchronize()
        return int(host)

    return read


def _ladder_round1(points, cand, evaluate):
    """Round 1 of the ladder over one chunk: every row's first candidate
    column (the nearest centroid or member) solved.  Returns ((elem, ref,
    acc, best_max), missed), ``missed() -> int`` the rows it left
    unaccepted (``_count_on_host``)."""
    elem = cand[:, 0].contiguous()
    with stage_timer("locate.round1"):
        ref, acc, best_max = _eval_rows(evaluate, points, elem)
    count("ladder.round1.rows", points.shape[0])
    return (elem, ref, acc, best_max), _count_on_host((~acc).sum())


def _ladder_chunk(points, cand, first, n_missed, evaluate, cfg, fallback,
                  C, rescue_by):
    """The escalation ladder over one chunk after round 1 (``first``, and
    ``n_missed`` the rows it left unaccepted, from ``_ladder_round1``).

    points [n, d] f64, cand [n, K] int32 (K = 1: the nearest centroid or
    member, whose failures take ``rescue_by.bucket_cands`` in rounds 2-3).
    The rescue rounds are sized by the failures, capped at
    ``rescue_by.caps(C)`` (``C`` the chunk's power-of-two row bucket):
    round r retries the ``_rescue_rows`` hardest failures, and a chunk
    that round 1 accepts whole skips rounds 2-4.  Returns (elements,
    refs, found, accepted, needs_retry)."""
    n, d = points.shape
    inf = float("inf")
    elem, ref, acc, best_max = first
    count("ladder.round1.missed", n_missed)
    b2, b3, b4 = (_rescue_rows(B, n_missed) for B in rescue_by.caps(C))
    if not (b2 or b3 or b4):
        # every row accepted: the best-so-far state is round 1's own
        count("ladder.rescue.skipped", 1)
        elements, refs, found = _assemble(
            fallback, cfg, acc, elem, ref, best_max, ref, elem,
            fb=(elem, _fixed_ref(n, d, points.device)))
        return elements, refs, found, acc, ~acc
    best_ref, best_elem = ref.clone(), elem.clone()

    def rescue(cols, idx, counter):
        """Retry rows ``idx`` on candidate columns ``cols`` [B, r]:
        first accepting column wins, best score updates best-so-far.
        Rows already accepted are left untouched.  ``idx`` is unique, so
        the indexed assignments below are plain scatters.  The B x r rows
        evaluated are added to ``counter``."""
        B, r = cols.shape
        if B == 0 or r == 0:
            return
        count(counter, B * r)
        ids_r = cols.T.contiguous()  # [r, B]
        refs_f, acc_f, score_f = _eval_rows(
            evaluate, points[idx].repeat(r, 1), ids_r.reshape(-1))
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
        diverged rows next, accepted rows last.  Stable: ties keep row
        order."""
        key = torch.where(
            acc, inf, torch.where(torch.isfinite(best_max), best_max, 1.5))
        return torch.argsort(key, stable=True)[:B]

    # ---- rounds 2-3: the next candidate columns ------------------------
    with stage_timer("locate.rounds23"):
        idx = failure_order(b2)
        table = cand  # round 1's own columns, else the parked top-k
        if rescue_by.bucket_cands is not None:
            # round 3 reads the parked top-k; a row that enters round 3
            # without a round-2 slot reads zeros and evaluates element 0
            # harmlessly, keeping its full-recall shot in round 4 / the
            # scan retry
            cand_b = rescue_by.bucket_cands(points[idx])
            table = torch.zeros((n, cand_b.shape[1]), dtype=torch.int32,
                                device=points.device)
            table[idx] = cand_b
        rescue(table[idx][:, 1:4], idx, "ladder.round2.rows")
        if table.shape[1] > 4:
            idx = failure_order(b3)
            rescue(table[idx][:, 4:12], idx, "ladder.round3.rows")
    # ---- round 4: full-budget re-search for the hardest failures -------
    with stage_timer("locate.round4"):
        idx = failure_order(b4)
        rescue(rescue_by.round4(points[idx]), idx, "ladder.round4.rows")
        full_op = torch.zeros((n,), dtype=torch.bool, device=points.device)
        full_op[idx] = True

    # under fixed_ref every unaccepted row takes the scan retry, so these
    # placeholders never reach the caller
    elements, refs, found = _assemble(
        fallback, cfg, acc, elem, ref, best_max, best_ref, best_elem,
        fb=(best_elem, _fixed_ref(n, d, points.device)))
    needs_retry = ~acc if fallback == "fixed_ref" else ~acc & ~full_op
    return elements, refs, found, acc, needs_retry


def _scan_candidates(points, cand, evaluate, cfg, fallback, prep):
    """Exhaustive scan of all K candidate columns in distance order,
    carrying first-accepted and best-so-far state per point and, for
    ``fixed_ref``, the reference's fallback choice: the first candidate
    whose AABB holds the point, else the candidate with the nearest AABB
    centre (the JAX package's _scan_candidates + _locate_chunk).
    Returns (elements, refs, found, accepted)."""
    n, d = points.shape
    dev = points.device
    inf = float("inf")
    first = cand[:, 0].contiguous()
    zeros = torch.zeros((n, d), dtype=torch.float32, device=dev)
    false = torch.zeros((n,), dtype=torch.bool, device=dev)
    acc, acc_ref, acc_elem = false, zeros, first
    best_max, best_ref, best_elem = torch.full((n,), inf, device=dev), \
        zeros, first
    in_found, in_ref, in_elem, in_conv = false, zeros, first, false
    near_d = torch.full((n,), inf, dtype=torch.float64, device=dev)
    near_ref, near_elem, near_conv = zeros, first, false
    for k in range(cand.shape[1]):
        ids = cand[:, k].contiguous()
        ref, conv, maxabs, inside, accepted = evaluate(points, ids)
        newly = accepted & ~acc
        acc_ref = torch.where(newly[:, None], ref, acc_ref)
        acc_elem = torch.where(newly, ids, acc_elem)
        acc = acc | accepted
        score = torch.where(conv, maxabs, inf)
        better = score < best_max
        best_max = torch.where(better, score, best_max)
        best_ref = torch.where(better[:, None], ref, best_ref)
        best_elem = torch.where(better, ids, best_elem)
        if fallback != "fixed_ref":
            continue
        # without use_aabb every candidate "holds" the point: column 0
        newly_in = ~in_found if inside is None else inside & ~in_found
        in_ref = torch.where(newly_in[:, None], ref, in_ref)
        in_elem = torch.where(newly_in, ids, in_elem)
        in_conv = torch.where(newly_in, conv, in_conv)
        in_found = in_found | newly_in
        if inside is not None:
            il = ids.long()
            dist = ((points - 0.5 * (prep.lo[il] + prep.hi[il])) ** 2
                    ).sum(dim=-1)
            nearer = dist < near_d
            near_d = torch.where(nearer, dist, near_d)
            near_ref = torch.where(nearer[:, None], ref, near_ref)
            near_elem = torch.where(nearer, ids, near_elem)
            near_conv = torch.where(nearer, conv, near_conv)
    fb = None
    if fallback == "fixed_ref":
        fb_ref = torch.where(in_found[:, None], in_ref, near_ref)
        fb_conv = torch.where(in_found, in_conv, near_conv)
        bad = ~fb_conv | (fb_ref.abs().amax(dim=-1) >= cfg.accept_tol)
        fb = (torch.where(in_found, in_elem, near_elem),
              torch.where(bad[:, None], _fixed_ref(n, d, dev), fb_ref))
    return (*_assemble(fallback, cfg, acc, acc_elem, acc_ref, best_max,
                       best_ref, best_elem, fb=fb), acc)


def _prefilter_rank(points, cand, solve1, m: int):
    """The ``m`` columns of ``cand`` [n, P] whose trilinear (8-corner)
    Newton gives the smallest max |ref|, re-sorted into distance order so
    the scan's first-accept semantics hold (the JAX package's
    _prefilter_rank).  One K1 launch over all P columns; ties keep the
    nearer column, as ``top_k`` does."""
    n, P = cand.shape
    ref, res = solve1(points.repeat(P, 1), cand.T.reshape(-1))
    score = torch.where(res < _F32_CONV_TOL, ref.abs().amax(dim=-1),
                        float("inf")).view(P, n).T
    pos = torch.argsort(score, dim=1, stable=True)[:, :m]
    return cand.gather(1, pos.sort(dim=1).values)


def _check_scope(cfg, fallback, strategy):
    if fallback not in _FALLBACKS:
        raise ValueError(f"unknown fallback mode {fallback!r}")
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")


def _empty(d, device):
    """(elements, refs, found, accepted) of zero rows."""
    return (torch.zeros((0,), dtype=torch.int32, device=device),
            torch.zeros((0, d), dtype=torch.float32, device=device),
            torch.zeros((0,), dtype=torch.bool, device=device),
            torch.zeros((0,), dtype=torch.bool, device=device))


def _rescan(rows, points, out, prep, evaluate, cfg, fallback, chunk,
            k_full, candidates=None, pbar=None):
    """Scan rows ``rows`` again with fresh candidates (the full ``k_full``
    list of ``grid.knn_any``, or the caller's ``candidates`` rows),
    chunked, and write their (elements, refs, found, accepted) into
    ``out`` in place, stepping ``pbar`` (a progress reporter) a chunk at
    a time."""
    for rs in range(0, int(rows.shape[0]), chunk):
        r = rows[rs:rs + chunk]
        pts_r = points[r]
        if candidates is not None:
            cand_r = candidates[r]
        else:
            cand_r = _grid.knn_any(prep.centroids, pts_r, k_full,
                                   sources_host=prep.centroids_host)[1]
        for dst, src in zip(out, _scan_candidates(pts_r, cand_r, evaluate,
                                                  cfg, fallback, prep)):
            dst[r] = src
        if pbar is not None:
            pbar.step(r.shape[0], device_value=out[0])


def _locate_ladder(points, prep, evaluate, cfg, fallback, chunk, k_full,
                   plain, candidates=None):
    """The ladder route: chunks, then the scan retry.  Returns (elements,
    refs, found, accepted, n_retry).  Given ``candidates`` [N, K] serve
    rounds 1-3 and the retry; round 4 keeps the route's own search."""
    N, d = points.shape
    device = points.device
    E = prep.centroids.shape[0]
    if E > _grid.APPROX_GRID_MIN_SOURCES:
        # the grid route: every search probes the balanced-bin index, so
        # no stage's cost grows with E.  Probe counts scale inversely with
        # the bin size, keeping the member coverage (probes x m) fixed:
        # accuracy is set by how many nearby members a round considers.
        index = _grid.get_grid_index(prep.centroids_host, ROUND1_MEMBERS,
                                     device)
        m = index.members_per_bin
        kk = min(12, index.n_bins * m)

        def round1(q):
            return _grid.nearest_member(index, q,
                                        n_probe=ROUND1_PROBES)[:, None]

        def round4(q):
            return _grid.probe_topk(index, q, cfg.nelem_to_search,
                                    max(16, 2048 // m))

        rescue_by = _Rescue(
            lambda q: _grid.probe_topk(index, q, kk, max(2, 256 // m)),
            round4, div=(32, 32, 32))
    else:
        def round4(q):
            return _knn.knn(prep.centroids, q, k_full)[1]

        if E > _NEAR1_MIN_SOURCES:
            center = prep.centroids.mean(dim=0)
            sources_c32 = (prep.centroids - center).to(torch.float32)

            def round1(q):
                return _knn.nearest_centroid(prep.centroids, q,
                                             plain=plain)[:, None]

            rescue_by = _Rescue(
                lambda q: _knn.centred_topk(sources_c32, q, center,
                                            min(8, E)),
                round4, div=(4, 32, 128))
        else:
            def round1(q):
                return _knn.knn(prep.centroids, q, min(k_full, 8))[1]

            rescue_by = _Rescue(None, round4, div=(4, 8, 128))
    if candidates is not None:
        # the caller's columns take rounds 1-3, capped as round 1's exact
        # columns are (C/4, C/8); round 4 is the route's
        rescue_by = _Rescue(None, round4, div=(4, 8, rescue_by.div[2]))

    def rescue_chunk(pts_c, cand_c, first, missed):
        C = 1 << max(0, pts_c.shape[0] - 1).bit_length()
        outs.append(_ladder_chunk(pts_c, cand_c, first, missed(), evaluate,
                                  cfg, fallback, C, rescue_by))
        pbar.step(pts_c.shape[0], device_value=outs[-1][0])

    outs, held = [], None
    with _progress(N, "locate", n_steps=-(-N // chunk)) as pbar:
        for s in range(0, N, chunk):
            pts_c = points[s:s + chunk]
            with stage_timer("locate.round1"):
                cand_c = (round1(pts_c) if candidates is None
                          else candidates[s:s + chunk])
            this = (pts_c, cand_c,
                    *_ladder_round1(pts_c, cand_c, evaluate))
            # the chunk before takes its rescue rounds only now: the card
            # runs this chunk's round 1 while the host waits for that
            # chunk's count of failures and queues its rounds
            if held is not None:
                rescue_chunk(*held)
            held = this
        if held is not None:
            rescue_chunk(*held)
    if not outs:
        return (*_empty(d, device), 0)
    elements, refs, found, accepted, needs_retry = (
        torch.cat(c) for c in zip(*outs))

    if fallback == "sentinel":
        # A point outside the global source AABB (with a halo covering
        # accept_tol's reach past the hull) is inside no element: its
        # sentinel result is already exact, so it skips the retry.
        # Snap/best/fixed_ref results depend on the state over all
        # candidates, so those retry every crowded-out row.
        glo = prep.lo.amin(dim=0)
        ghi = prep.hi.amax(dim=0)
        elem_ext = (prep.hi - prep.lo).amax(dim=0)
        eps = (cfg.accept_tol - 1.0) * elem_ext + 1e-5 * (ghi - glo)
        needs_retry &= ((points >= glo - eps)
                        & (points <= ghi + eps)).all(dim=-1)
    retry = torch.nonzero(needs_retry).squeeze(1)
    # Crowded-out rows: unaccepted points that never reached round 4 go
    # through the exhaustive scan with fresh exact candidates, so the
    # ladder degrades to the scan's semantics, never to a silent
    # fallback on an interior point.
    out = (elements, refs, found, accepted)
    n_retry = int(retry.shape[0])
    count("ladder.retry.rows", n_retry)
    with stage_timer("locate.retry"), _progress(
            n_retry, "locate retry", n_steps=-(-n_retry // chunk)) as rbar:
        _rescan(retry, points, out, prep, evaluate, cfg, fallback, chunk,
                k_full, candidates, rbar)
    return (*out, n_retry)


def _locate_scan(points, prep, evaluate, solve1, cfg, fallback, chunk,
                 k_full, prefilter_m, prefilter, candidates=None):
    """The scan route: exact candidates (or the caller's), the optional
    trilinear prefilter, the scan, and the full-list rescue of rows the
    prefiltered list did not accept.  Returns (elements, refs, found,
    accepted)."""
    N, d = points.shape
    outs = []
    with _progress(N, "locate", n_steps=-(-N // chunk)) as pbar:
        for s in range(0, N, chunk):
            pts_c = points[s:s + chunk]
            if candidates is not None:
                cand = candidates[s:s + chunk]
            else:
                cand = _grid.knn_any(prep.centroids, pts_c, k_full,
                                     sources_host=prep.centroids_host)[1]
            if prefilter:
                # only the nearest prefilter_pool candidates enter the
                # ranking
                pool = min(max(prefilter_m, cfg.prefilter_pool),
                           cand.shape[1])
                cand = _prefilter_rank(pts_c, cand[:, :pool], solve1,
                                       prefilter_m)
            outs.append(_scan_candidates(pts_c, cand, evaluate, cfg,
                                         fallback, prep))
            pbar.step(pts_c.shape[0], device_value=outs[-1][0])
    if not outs:
        return _empty(d, points.device)
    out = tuple(torch.cat(c) for c in zip(*outs))
    if prefilter:
        # the trilinear proxy can mis-rank candidates of strongly curved
        # elements: rows it left unaccepted take the full candidate list
        _rescan(torch.nonzero(~out[3]).squeeze(1), points, out, prep,
                evaluate, cfg, fallback, chunk, k_full, candidates)
    return out


def _f64_polish(points, elements, refs, accepted, prep, order, cfg, chunk):
    """Two f64 Newton steps from the f32 refs on the f64 lattice (the JAX
    package's locate.py:671-709, plain torch: it has no Pallas origin,
    and as the oracle of the df32 polish it shares no code with K4).
    An accepted row takes the polished ref where its residual is below
    the f32 convergence threshold; every row comes back f64."""
    d = points.shape[1]
    n_nodes = (order + 1) ** d
    out = []
    for s in range(0, points.shape[0], chunk):
        ids = elements[s:s + chunk].clamp_min(0).long()
        p_c = (points[s:s + chunk] - prep.ctr[ids]) * prep.inv_scale[ids,
                                                                     None]
        ref0 = refs[s:s + chunk].to(torch.float64)
        ref64, res = shape._newton_iterations(
            order, prep.nodes64[ids].view(-1, n_nodes, d), p_c, ref0,
            _F64_POLISH_ITERS, cfg.newton_clamp)
        good = accepted[s:s + chunk] & (res < _F32_CONV_TOL)
        out.append(torch.where(good[:, None], ref64, ref0))
    return torch.cat(out)


def _df32_polish(points, elements, refs, accepted, prep, order, cfg, chunk,
                 plain):
    """K4 over the accepted rows (the JAX package's locate.py:1445-1496):
    returns the pair (refs, refs_lo); rows the polish does not keep (not
    accepted, or a step over the guard) keep their f32 refs and lo = 0."""
    d = points.shape[1]
    fn = _polish.polish_pairs_ref if plain else _polish.polish_pairs
    his, los = [], []
    for s in range(0, points.shape[0], chunk):
        el = elements[s:s + chunk]
        ref0 = refs[s:s + chunk].contiguous()
        # raw ids: a -1 row comes back not ok (and the kernel's grouping
        # puts it in the last bin, not in element 0's)
        hi, lo, ok = fn(points[s:s + chunk].contiguous(), el.contiguous(),
                        ref0, prep.ctr, prep.inv_scale, prep.nodes64, order,
                        d, cfg.df32_polish_iters)
        keep = (accepted[s:s + chunk] & ok)[:, None]
        his.append(torch.where(keep, hi, ref0))
        los.append(torch.where(keep, lo, 0.0))
    return torch.cat(his), torch.cat(los)


def locate(points, elem_nodes, order: int,
           cfg: LocateConfig = DEFAULT_LOCATE, *, fallback: str = "sentinel",
           use_aabb: bool = False, centroids=None, candidates=None,
           prefilter_m: int = 0, strategy: str = "auto",
           chunk: int = 262_144, want_weights: bool = True, device=None,
           plain: bool = False) -> LocateResult:
    """Locate each query point in the source mesh.

    points [N, d] (numpy or tensor; moved to ``device`` -- None means
    ``cuda`` -- as f64);
    elem_nodes [E, (p+1)^d, d] (numpy or tensor, any E; prepared in f64,
    see ``_mesh_prep``; freeze a large lattice with
    ``setflags(write=False)`` and it is hashed once, not on every call).
    ``candidates`` [N, K] int (ids into ``elem_nodes``) skip the internal
    candidate search, and ``centroids`` [E, d] stand in for the elements'
    node means wherever candidates are searched (module docstring).
    ``fallback`` in {"sentinel", "snap",
    "best", "fixed_ref"}; ``strategy`` in {"auto", "ladder", "scan"}
    ("auto" is the ladder); ``prefilter_m`` > 0 ranks the scan's
    candidates by the trilinear prefilter; the polish options of ``cfg``
    run on the ladder only (the scan warns and skips them), except
    ``Precision.F64``, whose f64 polish runs on both.  On a CUDA
    device the Newton solves, the nearest-centroid round 1 (the grid
    route's searches are stock PyTorch) and the df32 polish run the
    hand-written kernels; on the CPU, their plain twins.
    ``plain=True`` runs the plain twins on any device (to check the
    kernels against them).
    """
    device = torch.device("cuda" if device is None else device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"locate: unsupported device {device}")
    if isinstance(elem_nodes, torch.Tensor):
        elem_nodes = elem_nodes.detach().cpu().numpy()
    elem_nodes = np.asarray(elem_nodes, dtype=np.float64)
    E, _, d = elem_nodes.shape
    _check_scope(cfg, fallback, strategy)
    ladder = strategy != "scan"
    # Precision.F64: f64 refs from f64_polish semantics, on either strategy
    f64 = cfg.precision == Precision.F64
    polish = cfg.f64_polish or cfg.df32_polish or f64
    if polish and not ladder and not f64:
        warnings.warn(
            "f64_polish / df32_polish run on the ladder only; "
            "strategy='scan' skips them", stacklevel=2)
        polish = False
    points = torch.as_tensor(points, dtype=torch.float64, device=device)
    N = points.shape[0]
    with stage_timer("locate.prep"):
        prep = _mesh_prep(elem_nodes, order, device, want64=polish)
    if centroids is not None:
        # a view of the cached prep with the caller's search centroids;
        # frozen, so the grid index keyed on them is hashed once
        cent = np.array(centroids, dtype=np.float64, order="C")
        cent_dev = torch.as_tensor(cent, device=device)
        cent.setflags(write=False)
        prep = dataclasses.replace(prep, centroids=cent_dev,
                                   centroids_host=cent)
    if candidates is not None:
        candidates = torch.as_tensor(candidates,
                                     device=device).to(torch.int32)
    solve = _row_solver(prep, prep.nodes, order, d,
                        cfg.newton_iters + cfg.polish_iters,
                        cfg.newton_clamp, plain)
    evaluate = _make_eval(solve, prep, cfg, use_aabb)
    k_full = min(cfg.nelem_to_search, E)

    n_retry = 0
    if ladder:
        elements, refs, found, accepted, n_retry = _locate_ladder(
            points, prep, evaluate, cfg, fallback, chunk, k_full, plain,
            candidates)
    else:
        k_avail = k_full if candidates is None else candidates.shape[1]
        prefilter = 0 < prefilter_m < k_avail and order > 1
        solve1 = _row_solver(prep, prep.corners, 1, d, cfg.prefilter_iters,
                             cfg.newton_clamp, plain)
        elements, refs, found, accepted = _locate_scan(
            points, prep, evaluate, solve1, cfg, fallback, chunk, k_full,
            prefilter_m, prefilter, candidates)

    refs_lo = None
    if polish and N:
        # after the retry, so scan-retried accepted rows are polished too
        with stage_timer("locate.polish"):
            if cfg.f64_polish or f64:
                refs = _f64_polish(points, elements, refs, accepted, prep,
                                   order, cfg, chunk)
            else:
                refs, refs_lo = _df32_polish(points, elements, refs,
                                             accepted, prep, order, cfg,
                                             chunk, plain)

    if want_weights:
        weights = torch.where(found[:, None],
                              gll.tensor_basis(order, refs), 0.0)
    else:
        weights = torch.zeros((N, 0), dtype=refs.dtype, device=device)
    return LocateResult(elements, refs, weights, found, accepted, refs_lo,
                        n_retry)
