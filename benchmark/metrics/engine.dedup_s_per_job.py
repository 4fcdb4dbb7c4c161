"""Seconds of the engine's dedup (stage ``g2g.dedup`` of
``engine.transfer_arrays``, ``ops/dedup.unique_points_device``: on the
card the coordinates' upload, the grouping ``dedup_first`` and the pull
of ``recon``) per job of the traced stretch."""


def read(ctx):
    s = ctx["stages"].get("g2g.dedup")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
