"""Seconds of the engine's host dedup (stage ``g2g.dedup`` of
``engine.transfer_arrays``, ``ops/dedup.py``) per job of the traced
stretch."""


def read(ctx):
    s = ctx["stages"].get("g2g.dedup")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
