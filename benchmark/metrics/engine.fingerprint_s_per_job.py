"""Seconds of the content fingerprints of the source and target lattices
in ``engine.transfer_arrays`` (stage ``g2g.fingerprint``) per job of the
traced stretch."""


def read(ctx):
    s = ctx["stages"].get("g2g.fingerprint")
    return s / ctx["jobs"] if s is not None and ctx["jobs"] else None
