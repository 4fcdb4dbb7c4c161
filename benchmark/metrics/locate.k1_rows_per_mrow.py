"""Rows K1 solved (the program's counter ``k1.rows``, summed over calls
of ``newton_rows``) per million rows located: one per row in round 1,
plus the rescue rounds', the scan retry's and any prefilter's.

The counter is read from ``utils_profile.counter_totals()``: the
benchmark's probe zeroed it (``reset_stages()``) when the traced stretch
began, and nothing runs the program between the stretch's end and the
readers.  None where round 1 (stage ``locate.round1``) never ran; 0
where it ran and the counter is missing."""


def read(ctx):
    rows = ctx["rows_located"]
    if "locate.round1" not in ctx["stages"] or not rows:
        return None
    from multimesh_tpu_torch import utils_profile

    return utils_profile.counter_totals().get("k1.rows", 0) / (rows / 1e6)
