"""Seconds of the locate ladder's scan retry (stage ``locate.retry``: the
crowded-out rows scanned again with fresh exact candidates, K1 once per
candidate column) per million rows located in the traced stretch.  None
where round 1 (``locate.round1``) never ran; 0 where no row was retried
(the stage opens on every ladder call, rows or none)."""


def read(ctx):
    stages, rows = ctx["stages"], ctx["rows_located"]
    if "locate.round1" not in stages or not rows:
        return None
    if not ctx["retry_rows"]:
        return 0.0
    return stages.get("locate.retry", 0.0) / (rows / 1e6)
