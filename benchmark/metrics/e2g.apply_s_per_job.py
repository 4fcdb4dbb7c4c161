"""Seconds of the Exodus path's apply (stage ``e2g.apply``: the trilinear
weights times the gathered nodal fields, relaid out to [npoints, F,
n_gll] and rounded to float32 on the card) per job of the traced
stretch."""


def read(ctx):
    s = ctx["stages"].get("e2g.apply")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
