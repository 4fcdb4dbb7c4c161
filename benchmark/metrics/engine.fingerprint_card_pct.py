"""Share of the bytes whose content-fingerprint weighted sums ran on the
card, in percent: 100 x counter ``fingerprint.card_bytes`` /
(``fingerprint.card_bytes`` + ``fingerprint.host_bytes``), the bytes the
kernel summed (``hashing.content_fingerprint_device``) and those numpy
summed (``hashing.content_hash``).  The words after an array's last
whole 16 KB row and its sub-word tail count in neither.

The counters are read from ``utils_profile.counter_totals()``: the
benchmark's probe zeroed them (``reset_stages()``) when the traced
stretch began, and nothing runs the program between the stretch's end
and the readers.  None where the engine (stage ``g2g.fingerprint``)
never ran, or where neither counter did: a program without them."""


def read(ctx):
    if "g2g.fingerprint" not in ctx["stages"]:
        return None
    from multimesh_tpu_torch import utils_profile

    counters = utils_profile.counter_totals()
    card = counters.get("fingerprint.card_bytes", 0)
    total = card + counters.get("fingerprint.host_bytes", 0)
    return 100.0 * card / total if total else None
