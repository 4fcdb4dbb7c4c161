"""Seconds of the grid route's two-level search (stages
``grid.probe_bins``: the bin scores and their ``topk``, and
``grid.rank_members``: the probed bins' members ranked) per million rows
located in the traced stretch, over every search of the ladder.  None
where the ladder's round 1 (stage ``locate.round1``) never ran; 0 where
it ran and the grid route did not."""


def read(ctx):
    stages, rows = ctx["stages"], ctx["rows_located"]
    if "locate.round1" not in stages or not rows:
        return None
    s = (stages.get("grid.probe_bins", 0.0)
         + stages.get("grid.rank_members", 0.0))
    return s / (rows / 1e6)
