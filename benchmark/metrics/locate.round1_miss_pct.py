"""Share of the rows of the ladder's round 1 that it left unaccepted, in
percent: 100 x counter ``ladder.round1.missed`` (the count the ladder
reads on the host once a chunk) / counter ``ladder.round1.rows``.  These rows are all the rescue rounds
can help.

The counters are read from ``utils_profile.counter_totals()``: the
benchmark's probe zeroed them (``reset_stages()``) when the traced
stretch began, and nothing runs the program between the stretch's end
and the readers.  None where round 1 (stage ``locate.round1``) never
ran; 0 where it ran and the counters are missing."""


def read(ctx):
    if "locate.round1" not in ctx["stages"]:
        return None
    from multimesh_tpu_torch import utils_profile

    counters = utils_profile.counter_totals()
    rows = counters.get("ladder.round1.rows", 0)
    missed = counters.get("ladder.round1.missed", 0)
    return 100.0 * missed / rows if rows else 0.0
