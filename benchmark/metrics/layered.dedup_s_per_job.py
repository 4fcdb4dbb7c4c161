"""Seconds of the layered path's dedup (stage ``layered.dedup``:
``ops/dedup.unique_points_per_layer``, each layer's target slots grouped
into unique rows, inside ``layered.masks_dedup``) per job of the traced
stretch; None on a program without the span."""


def read(ctx):
    s = ctx["stages"].get("layered.dedup")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
