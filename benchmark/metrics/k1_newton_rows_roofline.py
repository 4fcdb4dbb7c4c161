"""K1's share of its roofline: the least time the card could take for
the work the inputs need -- one Newton solve per row located, at the
configuration's newton_iters + polish_iters steps, and the lattice of
every element the rows fall in read once (``roofline.newton_work``) --
over the device time of K1's kernels by name in the trace, its grouping
pre-pass included.  The rescue rounds' and the retry's solves add time
and no counted work."""

from benchmark import roofline


def read(ctx):
    if not ctx["k1_device_s"] or not ctx["rows_located"]:
        return None
    flop, nbytes = roofline.newton_work(
        ctx["rows_located"], ctx["distinct_elements"], ctx["order"],
        ctx["dim"], ctx["newton_iters"])
    least, _ = roofline.bound(flop, roofline.PEAK_F32, nbytes)
    return 100.0 * least / ctx["k1_device_s"]
