"""Run one function on every rank of a fresh process group.

The port's stand-in for the JAX package's "every local device is one
mesh": ``run_ranks(fn, world_size, backend=...)`` spawns ``world_size``
processes that form one ``torch.distributed`` group and calls
``fn(rank, *args)`` in each.  The rendezvous is a ``FileStore`` in a
temporary directory of its own, so no TCP port is opened and runs in
parallel (test workers, say) cannot collide.  Each rank's result, a dict
of arrays, comes back to the caller through an ``.npz`` file.

A rank that raises, or a group that hangs (a collective one rank never
joins), makes ``run_ranks`` kill every rank and raise: the first within
moments, the second when ``timeout_s`` runs out, which is also the
group's own collective timeout.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection as mp_connection
import os
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _rank_main(fn, rank, world_size, backend, tmpdir, args, timeout_s):
    """One rank: join the group, run ``fn``, save its dict of arrays."""
    try:
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(tmpdir, "store"), world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, *args) or {}
        finally:
            dist.destroy_process_group()
        np.savez(os.path.join(tmpdir, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})
    except BaseException:
        with open(os.path.join(tmpdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _failures(procs, tmpdir) -> str:
    """Every failed rank's traceback, the earliest first: a rank that
    raises brings down the ranks waiting for it in a collective."""
    errs = []
    for rank, proc in enumerate(procs):
        path = os.path.join(tmpdir, f"rank{rank}.err")
        if os.path.exists(path):
            with open(path) as f:
                errs.append((os.path.getmtime(path), rank, f.read()))
        elif proc.exitcode not in (None, 0):
            errs.append((float("inf"), rank, f"exit code {proc.exitcode}"))
    return "\n".join(f"rank {rank} of {len(procs)} failed:\n{why}"
                     for _, rank, why in sorted(errs))


def run_ranks(fn, world_size: int, *, backend: str, args=(),
              timeout_s: float = 300.0) -> list[dict]:
    """``fn(rank, *args)`` on ``world_size`` spawned ranks of one
    ``backend`` group ("gloo" or "nccl"); returns each rank's result (a
    dict of numpy arrays; ``fn`` returns a dict of array-likes or None),
    in rank order.

    ``fn`` and ``args`` must pickle (a module-level function).  Where a
    CUDA device exists, rank r computes on card ``r % device_count``, so
    several ranks may share one card (with "gloo", whose exchanges are
    staged on the host).  Raises RuntimeError with the failed ranks'
    tracebacks if a rank fails, TimeoutError if the ranks have not all
    finished after ``timeout_s`` seconds; either way every rank is killed
    first."""
    ctx = mp.get_context("spawn")
    tmpdir = tempfile.mkdtemp(prefix="mmt_ranks_")
    procs = []
    try:
        for rank in range(world_size):
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(fn, rank, world_size, backend, tmpdir, args,
                      timeout_s))
            proc.start()
            procs.append(proc)
        deadline = time.monotonic() + timeout_s
        while True:
            if any(p.exitcode not in (None, 0) for p in procs):
                raise RuntimeError(_failures(procs, tmpdir))
            alive = [p.sentinel for p in procs if p.exitcode is None]
            if not alive:
                break
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{len(alive)} of {world_size} ranks still running "
                    f"after {timeout_s} s")
            mp_connection.wait(alive, timeout=min(left, 1.0))
        results = []
        for rank in range(world_size):
            with np.load(os.path.join(tmpdir, f"rank{rank}.npz")) as z:
                results.append({k: z[k] for k in z.files})
        return results
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
        for proc in procs:
            proc.join()
        shutil.rmtree(tmpdir, ignore_errors=True)
