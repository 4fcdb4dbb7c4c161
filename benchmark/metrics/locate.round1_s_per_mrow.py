"""Seconds of the locate ladder's round 1 (stage ``locate.round1``: the
nearest-centroid or nearest-member search and its K1 solve, timed on the
card's clock) per million rows located in the traced stretch."""


def read(ctx):
    s = ctx["stages"].get("locate.round1")
    rows = ctx["rows_located"]
    return s / (rows / 1e6) if s is not None and rows else None
