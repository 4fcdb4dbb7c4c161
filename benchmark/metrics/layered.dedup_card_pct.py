"""Share of the rows the layered path's dedup grouped on the card, in
percent: 100 x counter ``dedup.card_rows`` / (``dedup.card_rows`` +
``dedup.host_rows``), as ``engine.dedup_card_pct`` reads them.

The counters are read from ``utils_profile.counter_totals()``: the
benchmark's probe zeroed them (``reset_stages()``) when the traced
stretch began, and nothing runs the program between the stretch's end
and the readers.  None where the layered path (stage
``layered.masks_dedup``) never ran; 0 where it ran and neither counter
did."""


def read(ctx):
    if "layered.masks_dedup" not in ctx["stages"]:
        return None
    from multimesh_tpu_torch import utils_profile

    counters = utils_profile.counter_totals()
    card = counters.get("dedup.card_rows", 0)
    rows = card + counters.get("dedup.host_rows", 0)
    return 100.0 * card / rows if rows else 0.0
