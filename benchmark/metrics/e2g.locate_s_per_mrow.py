"""Seconds of the Exodus path's location step (stage ``e2g.locate``:
``TransferOperator.build`` on the hexes' corners and the missing-row
check) per million rows located in the traced stretch; None on a program
without the span."""


def read(ctx):
    s = ctx["stages"].get("e2g.locate")
    rows = ctx["rows_located"]
    return s / (rows / 1e6) if s is not None and rows else None
