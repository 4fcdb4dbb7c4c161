"""K1's share of its roofline in the regular-grid export, counted from
the rows it solved: counter ``k1.rows`` (every ``newton_rows`` call:
round 1, the rescue rounds and the scan retry, one row a candidate
column) at the configuration's newton_iters + polish_iters steps, and the
lattice of every element the located rows fall in read once
(``roofline.newton_work``, the f32 peak), over the device time of K1's
kernels by name in the trace, its grouping pre-pass included.
``k1_newton_rows_roofline`` counts one solve per row located, which
leaves out the retry's ~20 solves a retried row.

The counter is read from ``utils_profile.counter_totals()``: the
benchmark's probe zeroed it (``reset_stages()``) when the traced stretch
began, and nothing runs the program between the stretch's end and the
readers.  None where the export (stage ``regular.make_points``) never
ran, where the counter is missing, or where K1 took no time."""

from benchmark import roofline


def read(ctx):
    if "regular.make_points" not in ctx["stages"] or not ctx["k1_device_s"]:
        return None
    from multimesh_tpu_torch import utils_profile

    rows = utils_profile.counter_totals().get("k1.rows")
    if not rows:
        return None
    flop, nbytes = roofline.newton_work(
        rows, ctx["distinct_elements"], ctx["order"], ctx["dim"],
        ctx["newton_iters"])
    least, _ = roofline.bound(flop, roofline.PEAK_F32, nbytes)
    return 100.0 * least / ctx["k1_device_s"]
