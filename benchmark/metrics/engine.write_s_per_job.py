"""Seconds of the engine's streamed expansion, repair and write (stage
``g2g.stream_write``, ``engine._stream_expand_write``: the expansion on
the card, the finished blocks' pull through pinned memory, the host's
repair and its writes into the sink) per job of the traced stretch."""


def read(ctx):
    s = ctx["stages"].get("g2g.stream_write")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
