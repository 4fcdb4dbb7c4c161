"""Seconds of the Exodus path's pull and write (stage
``e2g.stream_write``: ``engine._stream_pull_write``, the host blocked on
each pinned block's copy and writing it into the sink) per job of the
traced stretch."""


def read(ctx):
    s = ctx["stages"].get("e2g.stream_write")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
