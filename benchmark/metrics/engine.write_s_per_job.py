"""Seconds of the engine's streamed host expansion, repair and write
(stage ``g2g.stream_write``, ``engine._stream_expand_write``) per job of
the traced stretch."""


def read(ctx):
    s = ctx["stages"].get("g2g.stream_write")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
