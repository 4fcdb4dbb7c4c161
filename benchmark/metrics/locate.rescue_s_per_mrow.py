"""Seconds of the locate ladder's rescue rounds (stages
``locate.rounds23`` and ``locate.round4``) per million rows located in
the traced stretch.  None where round 1 (``locate.round1``) never ran;
0 where it ran and no rescue round did."""


def read(ctx):
    stages, rows = ctx["stages"], ctx["rows_located"]
    if "locate.round1" not in stages or not rows:
        return None
    s = stages.get("locate.rounds23", 0.0) + stages.get("locate.round4", 0.0)
    return s / (rows / 1e6)
