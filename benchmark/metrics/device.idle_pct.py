"""Share of the traced stretch in which nothing ran on the card: 100 x
(1 - the union of all device operations' intervals / the stretch)."""


def read(ctx):
    if not ctx["device_events"] or not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
