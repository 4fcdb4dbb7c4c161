"""Chunk-level progress reporting for long-running loops.

The reference shows a tqdm bar on every hot loop (reference
multi_mesh/components/interpolator.py:1318-1326, :1522, :1571) and
periodic prints (:206-207); without an equivalent, a 100M-point locate
or a file-to-file transfer runs minutes with zero output.  This module
is the analogue (a copy of the JAX package's ``progress.py``): a
throttled, single-line reporter driven from the chunk loops: ``locate``'s
chunks and its scan retry ("locate", "locate retry"), the engine's
write-backs and the sharded transfer's apply.

Enablement (``MMT_PROGRESS``):

* unset  -- auto: report only when stderr is a TTY (interactive use);
  batch runs, pytest and the bench stay clean.
* ``1``  -- force on (line-per-update when stderr is not a TTY).
* ``0``  -- force off.

Device-honest pacing: CUDA launches are asynchronous, so a loop that
only dispatches them would sprint to 100% and then stall on the real
work.  Such a loop passes the last tensor it produced to
:meth:`Progress.step`; every ``n_steps // 20`` steps (and at the last)
the reporter waits for it by reading one of its elements, so the bar
tracks the device at ~5% granularity.  None of this happens when
reporting is disabled: the no-op reporter reads nothing.
"""
from __future__ import annotations

import os
import sys
import time


def progress_enabled() -> bool:
    env = os.environ.get("MMT_PROGRESS", "")
    if env == "0":
        return False
    if env == "1":
        return True
    try:
        return sys.stderr.isatty()
    except Exception:
        return False


def _fmt_count(x: float) -> str:
    if x >= 1e9:
        return f"{x / 1e9:.2f}G"
    if x >= 1e6:
        return f"{x / 1e6:.2f}M"
    if x >= 1e3:
        return f"{x / 1e3:.1f}k"
    return f"{x:.0f}"


class _NullProgress:
    def step(self, n, device_value=None):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


_NULL = _NullProgress()


class Progress:
    """Single-line ``label:  42%  4.2M/10M pts  5.1 M pts/s  ETA 1.1s``
    reporter; at most one redraw every ``min_interval`` seconds."""

    def __init__(self, total: int, label: str, unit: str = "pts",
                 n_steps: int | None = None, min_interval: float = 0.25):
        self.total = max(1, int(total))
        self.label = label
        self.unit = unit
        self.done = 0
        self.t0 = time.perf_counter()
        self._last_draw = 0.0
        self._min_interval = min_interval
        self._tty = True
        try:
            self._tty = sys.stderr.isatty()
        except Exception:
            self._tty = False
        # wait for the device about every 5% of the steps (>= 1): often
        # enough for an honest bar, rare enough to keep the queue full
        self._stride = max(1, (n_steps or 20) // 20)
        self._step_i = 0
        self._drew = False

    def step(self, n: int, device_value=None):
        """Advance by ``n`` units; ``device_value`` (a tensor, optional) is
        waited for on stride boundaries so the bar tracks the device."""
        self.done += int(n)
        self._step_i += 1
        if device_value is not None and device_value.numel() and (
            self._step_i % self._stride == 0 or self.done >= self.total
        ):
            device_value.reshape(-1)[:1].tolist()  # waits for its stream
        now = time.perf_counter()
        if (now - self._last_draw) < self._min_interval and (
            self.done < self.total
        ):
            return
        self._last_draw = now
        self._draw(now)

    def _draw(self, now: float):
        dt = max(now - self.t0, 1e-9)
        rate = self.done / dt
        pct = min(100.0, 100.0 * self.done / self.total)
        remain = max(self.total - self.done, 0)
        eta = remain / rate if rate > 0 else float("inf")
        msg = (
            f"{self.label}: {pct:3.0f}%  "
            f"{_fmt_count(self.done)}/{_fmt_count(self.total)} "
            f"{self.unit}  {rate / 1e6:.2f} M {self.unit}/s  "
            f"ETA {eta:.1f}s"
        )
        if self._tty:
            sys.stderr.write("\r\x1b[K" + msg)
            sys.stderr.flush()
        else:
            sys.stderr.write(msg + "\n")
        self._drew = True

    def close(self):
        """Finish the line (total wall + rate), once."""
        if not self._drew and self.done == 0:
            return
        now = time.perf_counter()
        dt = max(now - self.t0, 1e-9)
        msg = (
            f"{self.label}: done  {_fmt_count(self.done)} {self.unit} "
            f"in {dt:.1f}s  ({self.done / dt / 1e6:.2f} M {self.unit}/s)"
        )
        if self._tty:
            sys.stderr.write("\r\x1b[K" + msg + "\n")
        else:
            sys.stderr.write(msg + "\n")
        sys.stderr.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def progress(total: int, label: str, unit: str = "pts",
             n_steps: int | None = None, min_steps: int = 4):
    """A :class:`Progress` when reporting is enabled and the loop is
    long enough to be worth a bar (``n_steps >= min_steps``), else a
    shared no-op.  Call sites keep one unconditional code path::

        with progress(n_elem, "write-back", n_steps=n_blocks) as p:
            for ...:
                p.step(block_len)  # device loops: device_value=out
    """
    if not progress_enabled():
        return _NULL
    if n_steps is not None and n_steps < min_steps:
        return _NULL
    return Progress(total, label, unit=unit, n_steps=n_steps)
