"""Stage tracing: wall-clock stage timers + optional torch.profiler traces.

The reference's only observability is wall-clock prints around each API
call (reference multi_mesh/api.py:50-57) and tqdm bars in the hot loops.
Here every engine stage can be timed with device-complete semantics, and
a full trace can be captured for Perfetto / chrome://tracing.

Usage::

    from multimesh_tpu_torch.utils_profile import stage_timer, trace

    with trace("mmt_trace") as prof:       # profiler trace
        with stage_timer("locate") as t:   # per-stage wall clock
            res = locate(...)
            t.sync(res.elements)           # wait for the device
    prof.key_averages()                    # per-kernel device times

Enable automatic stage prints with MMT_PROFILE=1 in the environment.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

_STAGES: dict[str, float] = {}


def profiling_enabled() -> bool:
    return bool(os.environ.get("MMT_PROFILE"))


class _StageTimer:
    def __init__(self, name: str):
        self.name = name
        self.t0 = time.perf_counter()
        self.elapsed = None

    def sync(self, device_value):
        """Wait for the device of ``device_value`` (a CUDA tensor) before
        the timer stops; anything else has nothing to wait for."""
        if getattr(device_value, "is_cuda", False):
            torch.cuda.synchronize(device_value.device)
        return device_value

    def stop(self):
        self.elapsed = time.perf_counter() - self.t0
        _STAGES[self.name] = _STAGES.get(self.name, 0.0) + self.elapsed
        print(f"[mmt stage] {self.name:30s} {self.elapsed*1e3:9.2f} ms")


class _NullTimer:
    def sync(self, device_value):
        return device_value


_NULL = _NullTimer()


@contextlib.contextmanager
def stage_timer(name: str):
    """Accumulating per-stage wall-clock timer with device-complete
    semantics (printed when MMT_PROFILE=1; totals via stage_totals()).
    A no-op -- no timing, no forced device sync -- when profiling is
    off, so call sites can stay in the hot path permanently."""
    if not profiling_enabled():
        yield _NULL
        return
    t = _StageTimer(name)
    try:
        yield t
    finally:
        t.stop()


def stage_totals() -> dict[str, float]:
    """Accumulated seconds per stage name since reset_stages()."""
    return dict(_STAGES)


def reset_stages() -> None:
    _STAGES.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the enclosed block (host
    activity, and the card's when there is one), yield the profiler (its
    ``key_averages()`` hold the per-kernel device times once the block
    has ended) and write the trace as ``trace.json`` (chrome trace
    format) under ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
