"""What the traced run reads: the profiler's device events and the
benchmark's host spans, the program's stage seconds, launch counters and
the operators it built."""
from __future__ import annotations

import contextlib
import os

import torch


# the record_function ranges kept as host spans: the benchmark's own and
# the program's stages (``utils_profile.stage_timer`` under a profiler)
SPAN_PREFIXES = ("bench.", "mmt.")


def trace_events(prof):
    """(device ops [(name, start_s, end_s)], host spans [(start_s, end_s,
    name)] of the benchmark's ``bench.*`` and the program's ``mmt.*``
    record_function ranges) of a finished ``torch.profiler.profile``, on
    one clock.  Device ops are the kernels, copies and sets that ran on
    the card; the profiler's mirror of host annotations on the device
    timeline is left out."""
    dev, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        end = start + e.duration_ns() * 1e-9
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            mirror = getattr(e, "is_user_annotation", lambda: False)()
            if not (mirror or e.name().startswith(SPAN_PREFIXES)):
                dev.append((e.name(), start, end))
        elif e.name().startswith(SPAN_PREFIXES):
            spans.append((start, end, e.name()))
    return dev, spans


def distinct_elements(ops) -> int:
    """The distinct source elements each traced operator's rows fall in,
    summed over the operators ``program_probe`` kept."""
    return sum(int(seen[1:].sum()) for _, _, seen in ops)


@contextlib.contextmanager
def program_probe(ops: list):
    """While open: the program's stage timers on (``MMT_PROFILE=1``, from
    zero), and every operator ``TransferOperator.build`` returns appended
    to ``ops`` as (rows, scan-retry rows, seen): ``seen`` [E + 1] bool on
    the operator's device marks ``elements + 1``, so ``seen[1:]`` flags
    the source elements its rows fall in (filled without a host sync;
    ``distinct_elements`` counts them once the window has closed).
    Yields a function that returns the stage seconds and the launch
    counts of K1 and K2 since the probe opened."""
    from multimesh_tpu_torch import TransferOperator, utils_profile
    from multimesh_tpu_torch.search import nearest, newton

    original = TransferOperator.__dict__["build"]

    def build(cls, source_points, *args, **kwargs):
        op = original.__func__(cls, source_points, *args, **kwargs)
        el = op.elements
        seen = torch.zeros(len(source_points) + 1, dtype=torch.bool,
                           device=el.device)
        seen.index_fill_(0, el.long() + 1, True)
        ops.append((op.n_points, op.n_retry, seen))
        return op

    def launches():
        return {"newton_rows": newton.newton_rows.launches,
                "nearest_centroid": nearest.nearest.launches}

    before = launches()
    had = os.environ.get("MMT_PROFILE")
    os.environ["MMT_PROFILE"] = "1"
    utils_profile.reset_stages()
    TransferOperator.build = classmethod(build)

    def read():
        now = launches()
        return (utils_profile.stage_totals(),
                {k: now[k] - before[k] for k in now})

    try:
        yield read
    finally:
        TransferOperator.build = original
        if had is None:
            os.environ.pop("MMT_PROFILE", None)
        else:
            os.environ["MMT_PROFILE"] = had
