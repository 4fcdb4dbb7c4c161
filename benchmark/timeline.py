"""The arithmetic from a window's job times and a profiler trace to
metrics: the rate, the tail, the device's busy time and its idle gaps.
"""
from __future__ import annotations

import bisect
import math


def rate(units: float, start: float, end: float) -> float:
    """``units`` completed per second over [start, end]: the window from
    its start to the end of its last job."""
    return units / (end - start)


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between the
    two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals):
    """Sorted, merged [(start, end)] of possibly overlapping intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def clip(intervals, start, end):
    return [(max(s, start), min(e, end)) for s, e in intervals
            if e > start and s < end]


def busy(intervals, start, end) -> float:
    """Length of the union of ``intervals`` inside [start, end]."""
    return sum(e - s for s, e in union(clip(intervals, start, end)))


def gaps(intervals, start, end):
    """The idle stretches [(start, end)] of [start, end] that no interval
    covers."""
    out, t = [], start
    for s, e in union(clip(intervals, start, end)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out


def segments(spans):
    """Nested host spans (start, end, label) flattened into disjoint
    segments (start, end, label of the innermost span open there)."""
    bounds = sorted([(s, 1, -(e - s), label) for s, e, label in spans]
                    + [(e, 0, 0.0, label) for s, e, label in spans])
    out, stack, t = [], [], None
    for time, is_start, _, label in bounds:
        if stack and t is not None and time > t:
            out.append((t, time, stack[-1]))
        if is_start:
            stack.append(label)
        elif label in stack:
            stack.reverse()
            stack.remove(label)
            stack.reverse()
        t = time
    return out


def label_gaps(idle, spans):
    """Seconds of idle device time by the innermost host span open at
    each gap's midpoint: [(label, seconds)], largest first.  ``spans``
    are nested (start, end, label); a gap under no span is "outside
    spans"."""
    segs = segments(spans)
    starts = [sg[0] for sg in segs]
    totals = {}
    for s, e in idle:
        mid = 0.5 * (s + e)
        i = bisect.bisect_right(starts, mid) - 1
        label = (segs[i][2] if i >= 0 and mid < segs[i][1]
                 else "outside spans")
        totals[label] = totals.get(label, 0.0) + (e - s)
    return sorted(totals.items(), key=lambda kv: -kv[1])


def by_name(events):
    """Total seconds per name of (name, start, end) events, largest
    first."""
    totals = {}
    for name, s, e in events:
        totals[name] = totals.get(name, 0.0) + (e - s)
    return sorted(totals.items(), key=lambda kv: -kv[1])
