"""Seconds of ``TransferOperator.build`` (stage ``operator.build``) per
million rows located in the traced stretch."""


def read(ctx):
    s = ctx["stages"].get("operator.build")
    rows = ctx["rows_located"]
    return s / (rows / 1e6) if s is not None and rows else None
