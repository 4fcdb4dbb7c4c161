"""Query points or source elements sharded over the ranks of a mesh.

Counterpart of the JAX package's ``dist/sharding.py``, on
``torch.distributed`` with one process per rank: the JAX ``shard_map``
over a 1-D ``jax.sharding.Mesh`` becomes a 1-D ``DeviceMesh`` whose
ranks each call the entry with the same host inputs and each return the
full ``[N, F]`` result in input order.  Two schemes:

* ``sharded_transfer`` -- query points sharded, source geometry and
  fields replicated on every rank: rank r locates its contiguous block of
  rows with ``search.locate.locate`` (the ladder, the grid route above
  16,384 elements, the scan retry and every option, so the per-rank
  program is the single-device program), applies in f32 as
  ``TransferOperator.apply`` does, and one all-gather assembles the
  result.

* ``source_sharded_transfer`` -- for sources too large to replicate:
  source elements are split into spatially compact shards
  (``partition_source``), each point is routed to the shard owning its
  nearest bin (K2, ``search.nearest``), and location runs in two passes:
  a local try against the rank's own elements, then the misses of every
  rank, all-gathered, are tried by every rank against its elements and
  the best max |ref| wins.

Exchanges cross the group on the backend's device: CUDA tensors under
``nccl``, host tensors under any other backend (``gloo``), a rule read
from ``dist.get_backend(group)``; the compute stays on the rank's
``device``.  ``LAST_RUN`` holds this rank's counts of its last call.

Not carried over, on purpose (TPU plumbing): ``_engine_prep``'s split-f32
centring, ``_device_knn`` and the ``near1`` argmax candidate (``locate``
picks its own candidates), ``_ladder_step``'s cache of compiled
executables, the ``pn.BLOCK`` / ``quantum`` / ``_rows_feature_pad``
padding, the 32,768-row XLA:TPU cap, ``lax.map`` blocking (``locate``
chunks by ``chunk`` rows), and ``interpret``.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import shutil
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import DEFAULT_LOCATE, LocateConfig
from ..ops.transfer import TransferOperator
from ..progress import progress
from ..search import nearest as _nearest
from ..search.grid import build_grid
from ..search.locate import locate as _locate

_STRATEGIES = ("auto", "ladder", "scan")
_ENGINES = ("auto", "pallas", "xla")
# collective timeout of the one-rank group make_mesh starts itself
_TIMEOUT_S = 600

# this rank's counts of its last sharded_transfer / source_sharded_transfer
# call: "rows" it located, "exchange_s" in collectives (staging copies
# included), and for the source-sharded scheme the pass-2 "window" B, its
# pass-1 "misses", the "overflow" and "unfound" counts of all ranks
LAST_RUN: dict = {}


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def _start_single_rank_group(device: torch.device):
    """A one-rank process group: a ``FileStore`` in a temporary directory
    (removed at exit), ``nccl`` for a CUDA device, ``gloo`` otherwise."""
    tmpdir = tempfile.mkdtemp(prefix="mmt_mesh_")
    atexit.register(shutil.rmtree, tmpdir, True)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(tmpdir, "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=_TIMEOUT_S))


def make_mesh(n_devices: int | None = None, axis: str = "points",
              device=None) -> DeviceMesh | None:
    """A 1-D ``DeviceMesh`` named ``(axis,)`` over the first
    ``n_devices`` ranks of the process group (all of them by default).

    With no process group yet and ``n_devices`` in (None, 1), it starts a
    one-rank group itself (a ``FileStore`` in a temporary directory,
    ``nccl`` for a CUDA ``device`` -- None means ``cuda`` -- and ``gloo``
    for the CPU, a 600 s collective timeout), so that ``make_mesh(1)``
    works in a plain process as the JAX one does.  Several ranks come
    from ``torchrun`` or ``launch.run_ranks``.  Every rank of the group
    must call it; ranks beyond ``n_devices`` get None.  ``n_devices``
    above the world size raises ValueError."""
    device = _device(device)
    if not dist.is_initialized():
        if n_devices in (None, 1):
            _start_single_rank_group(device)
        else:
            raise ValueError(
                f"requested a {n_devices}-device mesh but only 1 rank is "
                "available (no process group: start one with torchrun or "
                "launch.run_ranks)")
    world = dist.get_world_size()
    if n_devices is not None and world < n_devices:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {world} ranks "
            f"are available ({dist.get_backend()})")
    n = world if n_devices is None else n_devices
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if dist.get_rank() >= n:
        return None
    return DeviceMesh.from_group(group, device.type, mesh_dim_names=(axis,))


def _all_gather(t, group, device, stats):
    """Every rank's ``t`` (equal shapes on all ranks) stacked, [W, ...] on
    ``device``; the exchange runs on CUDA under ``nccl``, on the host
    under any other backend, and its seconds go to ``stats``."""
    nccl = dist.get_backend(group) == "nccl"
    if nccl and device.type != "cuda":
        raise ValueError(f"an nccl group exchanges CUDA tensors, not {device}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    src = t.to(device if nccl else "cpu").contiguous()
    outs = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(outs, src, group=group)
    out = torch.stack(outs).to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["exchange_s"] += time.perf_counter() - t0
    return out


def _mesh_group(mesh, axis, device):
    """(group, size, rank) of ``mesh``, made over every rank if None."""
    if mesh is None:
        mesh = make_mesh(axis=axis, device=device)
    return mesh.get_group(), mesh.size(), mesh.get_local_rank()


def _check(strategy, engine):
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if engine not in _ENGINES:
        raise ValueError(f"unknown engine {engine!r}")


def sharded_transfer(points, elem_nodes, fields, order: int,
                     cfg: LocateConfig = DEFAULT_LOCATE, *,
                     fallback: str = "sentinel", use_aabb: bool = False,
                     mesh: DeviceMesh | None = None, axis: str = "points",
                     engine: str = "auto", strategy: str = "auto",
                     chunk: int = 262_144, device_out: bool = False,
                     device=None, plain: bool = False):
    """Locate + interpolate with query points sharded across the mesh.

    points [N, d] (numpy, or a tensor: one on ``device`` is sliced in
    place, never copied through the host); elem_nodes [E, (p+1)^d, d];
    fields [F, E, (p+1)^d].  Every rank of ``mesh`` (None: all ranks,
    see ``make_mesh``) calls it with the same inputs and returns values
    [N, F] in input order: f64 numpy, or with ``device_out=True`` the
    f32 tensor on ``device`` (None means ``cuda``).

    Rank r locates rows [r*ceil(N/W), (r+1)*ceil(N/W)) through
    ``search.locate.locate`` with this ``cfg``, ``fallback``,
    ``use_aabb``, ``strategy`` ("auto"/"ladder", or "scan") and ``chunk``
    (the rows of one ladder chunk), and applies the result as
    ``TransferOperator.apply``: at W = 1 the values are the single-device
    operator's, bit for bit.  ``df32_polish`` is dropped with a warning
    (the sharded apply takes f32 refs, as in the JAX package);
    ``f64_polish`` is kept.  ``engine`` is the JAX package's name of the
    Newton backend and is only checked: the port runs the kernels on a
    CUDA device and their twins on the CPU, or with ``plain=True``
    anywhere.  A progress bar (``progress.progress``) follows the values
    into the exchange buffer, waiting for the card as it goes."""
    _check(strategy, engine)
    if device_out and strategy == "scan":
        raise ValueError("device_out requires the ladder strategy")
    device = _device(device)
    if cfg.df32_polish:
        warnings.warn(
            "df32_polish is not applied by sharded_transfer (the sharded "
            "apply consumes f32 refs); use f64_polish or the single-device "
            "TransferOperator path for pair-precision values", stacklevel=2)
        cfg = dataclasses.replace(cfg, df32_polish=False)
    group, W, rank = _mesh_group(mesh, axis, device)
    stats = LAST_RUN
    stats.clear()
    stats.update(scheme="sharded", exchange_s=0.0)
    N, F = points.shape[0], fields.shape[0]
    dtype = torch.float64 if cfg.f64_polish else torch.float32
    if N == 0:
        stats["rows"] = 0
        out = torch.zeros((0, F), dtype=dtype, device=device)
        return out if device_out else np.zeros((0, F))

    per = -(-N // W)
    lo, hi = min(rank * per, N), min((rank + 1) * per, N)
    res = _locate(points[lo:hi], elem_nodes, order, cfg, fallback=fallback,
                  use_aabb=use_aabb, strategy=strategy, chunk=chunk,
                  want_weights=False, device=device, plain=plain)
    op = TransferOperator(elements=res.elements, order=order, refs=res.refs,
                          found=res.found)
    stats.update(rows=hi - lo, n_retry=res.n_retry)
    send = torch.zeros((per, F), dtype=dtype, device=device)
    chunks, step = op.apply(fields, out_chunks=True)
    with progress(hi - lo, "sharded transfer", n_steps=len(chunks)) as pbar:
        for i, vals in enumerate(chunks):
            send[i * step:i * step + vals.shape[0]] = vals
            pbar.step(vals.shape[0], device_value=vals)
    out = _all_gather(send, group, device, stats).view(W * per, F)[:N]
    return out if device_out else out.cpu().numpy().astype(np.float64)


# ---------------------------------------------------------------------------
# Source-sharded transfer (two passes: local try, then all-gathered retry)
# ---------------------------------------------------------------------------
def partition_source(elem_nodes, n_shards: int):
    """Split source elements into spatially compact, size-balanced shards.

    Contiguous runs of the median-split bin curve (``search.grid``,
    32 members a bin) are assigned to shards by cumulative element count,
    so each shard is a compact region of the domain and shard sizes differ
    by at most one bin.  Returns (shard_elem_ids: list of [E_s] int64
    arrays of global ids, bin_reps [n_bins, d] f32 centred, rep_center
    [d] f64, bin_shard [n_bins] int32), all numpy: the bin data doubles
    as the query-routing table.  The same shards as the JAX package's."""
    if isinstance(elem_nodes, torch.Tensor):
        elem_nodes = elem_nodes.detach().cpu().numpy()
    cents = np.asarray(elem_nodes, np.float64).mean(axis=1)
    index = build_grid(cents, target_per_cell=32, device="cpu")
    elems = index.bin_elems.numpy()
    counts = index.bin_counts
    csum = np.cumsum(counts) - counts
    per = max(1.0, counts.sum() / n_shards)
    bin_shard = np.minimum((csum / per).astype(np.int64),
                           n_shards - 1).astype(np.int32)
    shard_elem_ids = []
    for s in range(n_shards):
        sel = np.where(bin_shard == s)[0]
        ids = np.concatenate(
            [elems[i, :counts[i]] for i in sel]
        ) if sel.size else np.zeros((0,), np.int32)
        shard_elem_ids.append(ids.astype(np.int64))
    return (shard_elem_ids, index.bin_reps32.numpy(), index.center.numpy(),
            bin_shard)


def route_points(points, bin_reps32, rep_center, bin_shard, *,
                 plain: bool = False):
    """The shard of each point's nearest bin representative, [N] int64
    on the points' device: K2 (``search.nearest``) on a CUDA tensor, its
    twin on the CPU or with ``plain``.  K2 ranks in f32 centred on the
    representatives' mean, the JAX package on ``rep_center``: near-tied
    points may go to the other shard, which only pass 2 sees."""
    dev = points.device
    reps = (torch.as_tensor(bin_reps32, device=dev).double()
            + torch.as_tensor(rep_center, device=dev))
    near = _nearest.nearest_centroid_ref if plain else _nearest.nearest
    idx = near(points, reps)
    return torch.as_tensor(bin_shard, device=dev).long()[idx.long()]


def pass_cfg(cfg: LocateConfig, fallback: str) -> LocateConfig:
    """The locate configuration of both passes: no polish (a single-device
    TransferOperator concern) and, under snap, no score ceiling, so that
    every converged candidate stays comparable across ranks (the clipping
    happens when values are assembled)."""
    return dataclasses.replace(
        cfg, f64_polish=False, df32_polish=False,
        fallback_max=float("inf") if fallback == "snap" else cfg.fallback_max)


def local_try(points, nodes, fields, order, cfg, snap, *, strategy, chunk,
              device, plain):
    """One rank's locate of ``points`` [n, d] in its own elements
    ``nodes`` under "best" semantics: (score [n], values [n, F] f32, the
    ``LocateResult`` or None for no rows or no elements).
    The score is the chosen candidate's max |ref|, unclipped so that it
    compares across ranks, inf where nothing was found; the values
    interpolate the rank's ``fields`` at those refs, with ``snap`` those
    of unaccepted rows clipped to +/- ``cfg.snap_clip``.  (The JAX
    package clips accepted rows too, though its comment means not to:
    their refs may lie between snap_clip and accept_tol.)"""
    n, F = points.shape[0], fields.shape[0]
    if n == 0 or nodes.shape[0] == 0:
        return (torch.full((n,), float("inf"), device=device),
                torch.zeros((n, F), dtype=torch.float32, device=device), None)
    res = _locate(points, nodes, order, cfg, fallback="best",
                  strategy=strategy, chunk=chunk, want_weights=False,
                  device=device, plain=plain)
    score = torch.where(res.found, res.refs.abs().amax(dim=-1),
                        float("inf"))
    refs = res.refs
    if snap:
        refs = torch.where(res.accepted[:, None], refs,
                           refs.clamp(-cfg.snap_clip, cfg.snap_clip))
    op = TransferOperator(elements=res.elements, order=order, refs=refs,
                          found=res.found)
    return score, op.apply(fields), res


def source_sharded_transfer(points, elem_nodes, fields, order: int,
                            cfg: LocateConfig = DEFAULT_LOCATE, *,
                            mesh: DeviceMesh | None = None,
                            axis: str = "shards", engine: str = "auto",
                            retry_frac: int = 4, fallback: str = "sentinel",
                            chunk: int = 262_144, strategy: str = "auto",
                            device=None, plain: bool = False):
    """Locate + interpolate with SOURCE ELEMENTS sharded across the mesh
    (for sources too large to replicate on one card).

    points [N, d]; elem_nodes [E, (p+1)^d, d]; fields [F, E, (p+1)^d].
    Every rank calls it with the same host inputs and returns values
    [N, F] in input order, f64 numpy.  ``fallback`` selects the cross-rank
    failure semantics:

    * ``"sentinel"`` -- zero where no rank accepted the point;
    * ``"best"``     -- the best-scoring candidate across ALL ranks, used
      unclipped if its max |ref| < cfg.fallback_max, else zero;
    * ``"snap"``     -- the best-scoring candidate across all ranks with
      refs clipped to +/- cfg.snap_clip.

    Rank r holds only its shard of ``partition_source`` on ``device``
    (None means ``cuda``).  Pass 1: every point goes to the rank owning
    its nearest bin (``route_points``), which locates it among its own
    elements (``local_try``: ``locate`` in "best" mode, no polish).
    Pass 2: each rank takes its first B = max(P // retry_frac, min(P,
    64)) misses (P the largest count of points a rank owns), the misses
    of all ranks are all-gathered and every rank locates them among its
    elements; the lowest score of all ranks wins where it beats the
    owner's and the owner did not accept the point.  Misses beyond B keep
    their pass-1 result: their count is printed, as is the count of
    points no rank found.  ``engine`` is only checked (see
    ``sharded_transfer``); ``plain=True`` runs the kernels' twins."""
    if fallback not in ("sentinel", "best", "snap"):
        raise ValueError(
            f"source_sharded_transfer: unknown fallback {fallback!r}")
    _check(strategy, engine)
    device = _device(device)
    group, W, rank = _mesh_group(mesh, axis, device)
    stats = LAST_RUN
    stats.clear()
    stats.update(scheme="source_sharded", exchange_s=0.0)
    if isinstance(elem_nodes, torch.Tensor):
        elem_nodes = elem_nodes.detach().cpu().numpy()
    elem_nodes = np.asarray(elem_nodes, np.float64)
    fields = torch.as_tensor(fields)
    pts = torch.as_tensor(points, dtype=torch.float64, device=device)
    N, d = pts.shape
    F = fields.shape[0]
    if N == 0:
        stats.update(rows=0, window=0, misses=0, overflow=0, unfound=0)
        return np.zeros((0, F))
    loc_cfg = pass_cfg(cfg, fallback)
    limit = {"sentinel": cfg.accept_tol, "best": cfg.fallback_max,
             "snap": float("inf")}[fallback]

    # ---- partition and routing, the same on every rank -----------------
    shard_ids, bin_reps, rep_center, bin_shard = partition_source(
        elem_nodes, W)
    owner = route_points(pts, bin_reps, rep_center, bin_shard, plain=plain)
    perm = torch.argsort(owner, stable=True)
    counts = torch.bincount(owner, minlength=W).tolist()
    P = max(counts)
    B = max(P // retry_frac, min(P, 64))
    start = sum(counts[:rank])
    mine = perm[start:start + counts[rank]]
    # the rank's own elements, in global order, are all it uploads
    ids = np.sort(shard_ids[rank])
    nodes = elem_nodes[ids]
    flds = fields[:, torch.as_tensor(ids, device=fields.device)].to(device)

    def try_here(rows):
        return local_try(rows, nodes, flds, order, loc_cfg,
                         fallback == "snap", strategy=strategy, chunk=chunk,
                         device=device, plain=plain)[:2]

    # ---- pass 1: local try ----------------------------------------------
    pts_mine = pts[mine]
    score, vals = try_here(pts_mine)
    miss = torch.nonzero(score >= cfg.accept_tol).squeeze(1)
    sent = miss[:B]

    # ---- pass 2: all-gather the compacted misses --------------------------
    n_miss = _all_gather(torch.tensor([miss.numel()], device=device), group,
                         device, stats).view(W).tolist()
    n_sent = [min(m, B) for m in n_miss]
    M = max(n_sent)
    if M:
        buf = torch.zeros((M, d), dtype=torch.float64, device=device)
        buf[:n_sent[rank]] = pts_mine[sent]
        got = _all_gather(buf, group, device, stats)
        flat = torch.cat([got[r, :n_sent[r]] for r in range(W)])
        score2, vals2 = try_here(flat)
        g_score = _all_gather(score2, group, device, stats)  # [W, DB]
        g_vals = _all_gather(vals2, group, device, stats)  # [W, DB, F]
        winner = g_score.argmin(dim=0)  # the lowest rank on a tie
        cols = torch.arange(flat.shape[0], device=device)
        off = sum(n_sent[:rank])
        w_score = g_score[winner, cols][off:off + n_sent[rank]]
        w_vals = g_vals[winner, cols][off:off + n_sent[rank]]
        # sent rows are all local misses: the owner's accepts stay (it
        # holds the nearest candidates, matching single-device
        # first-accept-in-distance-order semantics)
        upd = w_score < score[sent]
        score[sent] = torch.where(upd, w_score, score[sent])
        vals[sent] = torch.where(upd[:, None], w_vals, vals[sent])
    found = score < limit
    vals = torch.where(found[:, None], vals, 0.0)

    # ---- every rank's rows back in input order ----------------------------
    send = torch.zeros((P, F + 1), dtype=torch.float32, device=device)
    send[:counts[rank], :F] = vals
    send[:counts[rank], F] = found.float()
    got = _all_gather(send, group, device, stats)
    rows = torch.cat([got[r, :counts[r]] for r in range(W)])
    out = torch.empty_like(rows)
    out[perm] = rows
    out = out.cpu().numpy()
    n_overflow = sum(max(m - B, 0) for m in n_miss)
    unfound = int(N - out[:, F].sum())
    stats.update(rows=counts[rank], window=B, misses=n_miss[rank],
                 overflow=n_overflow, unfound=unfound)
    if rank == 0 and n_overflow:
        print(f"{n_overflow} points missed locally but did not fit the "
              f"cross-rank retry window (B={B} per rank) and kept their "
              "local result; lower retry_frac to widen the window")
    if rank == 0 and unfound:
        print(f"{unfound} points could not find an enclosing element "
              "across any source shard. These points will be set to zero.")
    return out[:, :F].astype(np.float64)
