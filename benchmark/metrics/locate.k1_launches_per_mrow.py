"""K1 launches (the program's counter ``newton_rows.launches``) per
million rows located: the ladder's rounds and the scan retry."""


def read(ctx):
    rows = ctx["rows_located"]
    return ctx["launches"]["newton_rows"] / (rows / 1e6) if rows else None
