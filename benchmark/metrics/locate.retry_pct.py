"""Share of the rows located that the scan retry ran again (the sum of
the operators' ``n_retry`` over their rows), in percent."""


def read(ctx):
    rows = ctx["rows_located"]
    return 100.0 * ctx["retry_rows"] / rows if rows else None
