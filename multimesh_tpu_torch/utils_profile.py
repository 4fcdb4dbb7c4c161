"""Stage tracing: the port's spans and counters, and torch.profiler traces.

The reference's only observability is wall-clock prints around each API
call (reference multi_mesh/api.py:50-57) and tqdm bars in the hot loops.
Here the engine, the locate ladder and the grid search open named stages
(``stage_timer``) and bump named counters (``count``) where the work
happens.  Both record only with ``MMT_PROFILE`` set in the environment;
otherwise each costs one check and records nothing.

While recording:

* a stage is timed on the card's clock: a start and an end
  ``torch.cuda.Event`` on the current stream (``time.perf_counter`` while
  CUDA is not initialised), so a reading is device-complete without a
  forced sync.  Seconds accumulate inclusively per name; the pending
  event pairs are resolved when ``stage_totals()`` is read, and that
  read is where the host waits for the card;
* under an active ``torch.profiler`` a stage is also a
  ``record_function("mmt.<name>")`` range, so it sits in the trace on
  the device events' clock, nested under whatever range the caller
  opened;
* an outermost stage (one opened inside no other) notes how far
  ``torch.cuda.max_memory_allocated()`` rose while it ran
  (``stage_peaks()``);
* ``count(name, n)`` adds ``n``, an int or a 0-d device tensor (summed on
  the device), to a counter (``counter_totals()``).

``report()`` prints one table of all of it on standard error (the CLI
calls it after a command); nothing is printed while recording.

Usage::

    from multimesh_tpu_torch import utils_profile

    os.environ["MMT_PROFILE"] = "1"
    utils_profile.reset_stages()
    with utils_profile.trace("mmt_trace") as prof:   # profiler trace
        op = TransferOperator.build(...)              # stages + counters
    utils_profile.stage_totals()     # {"operator.build": s, ...}
    utils_profile.counter_totals()   # {"k1.rows": n, ...}
    utils_profile.report()           # the table, on stderr
    prof.key_averages()              # per-kernel device times

The recorder counts the open stages as one nest, for code that runs
them on one thread, as the port does.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

import torch


def profiling_enabled() -> bool:
    return bool(os.environ.get("MMT_PROFILE"))


class _Recorder:
    """Stage seconds, call counts, peak rises and counters since the last
    ``reset``."""

    def __init__(self):
        self.depth = 0  # stages open
        self.reset()

    def reset(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.pending: list = []  # (name, start event, end event)
        self.free: list = []  # events of resolved pairs, recorded again
        self.counts: dict = {}  # name -> int or 0-d device tensor
        self.peak_rise: dict[str, int] = {}
        self.mem = 0  # the allocator's peak as the outermost stage opened

    def _peak(self):
        """The allocator's peak, a host read of its statistics (no sync),
        read as nested statistics: ``max_memory_allocated()`` flattens
        them first, at eight times the cost on an H100's host."""
        return torch.cuda.memory_stats_as_nested_dict()["allocated_bytes"][
            "all"]["peak"]

    def open(self, span):
        """Start ``span``: its profiler range, its peak reading if it is
        the outermost stage, its start mark."""
        if torch.autograd._profiler_enabled():
            span.range = torch.profiler.record_function("mmt." + span.name)
            span.range.__enter__()
        span.on_card = torch.cuda.is_initialized()
        if span.on_card and not self.depth:
            self.mem = self._peak()
        self.depth += 1
        span.start = self.mark(span.on_card)

    def mark(self, on_card: bool):
        """A point on the stages' clock: an event recorded on the current
        stream (one of a resolved pair where there is one: creating
        events costs the host more) or, off the card, the host's clock."""
        if not on_card:
            return time.perf_counter()
        event = (self.free.pop() if self.free
                 else torch.cuda.Event(enable_timing=True))
        event.record()
        return event

    def close(self, span):
        name = span.name
        end = self.mark(span.on_card)
        if span.on_card:
            self.pending.append((name, span.start, end))
            self._resolve(wait=False)
        else:
            self._add(name, end - span.start)
        self.calls[name] = self.calls.get(name, 0) + 1
        if span.range is not None:
            span.range.__exit__(None, None, None)
        self.depth -= 1
        if span.on_card and not self.depth:
            rise = self._peak() - self.mem
            if rise > 0:
                self.peak_rise[name] = self.peak_rise.get(name, 0) + rise

    def _add(self, name, seconds):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds

    def _resolve(self, wait: bool):
        """Turn pending event pairs into seconds and their events free:
        all of them, waiting for the card (``wait``), or the leading ones
        that have completed (at every stage's end, so the pending list
        stays short and the events are reused)."""
        done = 0
        for name, start, end in self.pending:
            if not end.query():
                if not wait:
                    break
                end.synchronize()  # the read's one wait on the card
            self._add(name, start.elapsed_time(end) * 1e-3)
            self.free += (start, end)
            done += 1
        del self.pending[:done]


class _Span:
    __slots__ = ("name", "range", "start", "on_card")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        _REC.open(self)

    def __exit__(self, *exc):
        _REC.close(self)


_REC = _Recorder()
_OFF = contextlib.nullcontext()


def stage_timer(name: str):
    """A context manager that times the enclosed block as stage ``name``
    (module docstring).  Without ``MMT_PROFILE`` it is a shared no-op:
    no event, no clock read, nothing allocated."""
    if not profiling_enabled():
        return _OFF
    return _Span(name)


def count(name: str, n) -> None:
    """Add ``n`` (an int, or a 0-d tensor summed where it lives, without
    a sync) to counter ``name``; nothing without ``MMT_PROFILE``.  A call
    site that would reduce on the device to make ``n`` checks
    ``profiling_enabled()`` first."""
    if profiling_enabled():
        _REC.counts[name] = _REC.counts.get(name, 0) + n


def stage_totals() -> dict[str, float]:
    """Inclusive seconds per stage name since reset_stages(); waits for
    the card until every pending stage has ended there."""
    _REC._resolve(wait=True)
    return dict(_REC.seconds)


def stage_peaks() -> dict[str, int]:
    """Bytes by which ``torch.cuda.max_memory_allocated()`` rose during
    each outermost stage (one opened inside no other), since
    reset_stages()."""
    return dict(_REC.peak_rise)


def counter_totals() -> dict[str, int]:
    """Every counter since reset_stages(), as ints (device sums read)."""
    return {k: int(v) for k, v in _REC.counts.items()}


def reset_stages() -> None:
    """Zero the stages, their peaks and the counters."""
    _REC.reset()


def report(file=None) -> None:
    """Print the stage totals (seconds, calls, ms per call, peak rise)
    and the counters as one table on ``file`` (standard error)."""
    file = sys.stderr if file is None else file
    seconds, calls = stage_totals(), dict(_REC.calls)
    peaks, counters = stage_peaks(), counter_totals()
    lines = [f"{'mmt stage':32s} {'s':>10s} {'calls':>7s} "
             f"{'ms/call':>10s} {'peak+ MiB':>10s}"]
    for name in sorted(seconds, key=lambda k: -seconds[k]):
        n = calls.get(name, 0)
        lines.append(f"{name:32s} {seconds[name]:10.4f} {n:7d} "
                     f"{1e3 * seconds[name] / max(n, 1):10.3f} "
                     f"{peaks.get(name, 0) / 2**20:10.1f}")
    for name in sorted(counters):
        lines.append(f"{'mmt counter ' + name:51s} {counters[name]:d}")
    print("\n".join(lines), file=file, flush=True)


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
