"""Seconds of the layered path's apply and write (stage
``layered.apply_write``: each layer's apply and the pull of its values,
span ``layered.apply`` inside it, and the host's scatter of them into the
target's fields) per job of the traced stretch."""


def read(ctx):
    s = ctx["stages"].get("layered.apply_write")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
