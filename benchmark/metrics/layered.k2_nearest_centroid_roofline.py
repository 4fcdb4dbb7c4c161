"""K2's share of its roofline in the layered path, counted from the pairs
it scored: 2 x 3 FLOP a (query, centroid) pair (counter ``k2.pairs``:
each launch's queries times the centroids of the layer it searched) and
(8 x 3 + 4) bytes a query (counter ``k2.rows``), at the f32 peak
(``roofline.bound``), over the device time of ``nearest_centroid_kernel``
in the trace.  None where the layered build (stage ``layered.build``)
never ran, where the program has no such counter, or where the kernel
took no time."""

from benchmark import roofline


def read(ctx):
    if "layered.build" not in ctx["stages"] or not ctx["k2_device_s"]:
        return None
    from multimesh_tpu_torch import utils_profile

    counters = utils_profile.counter_totals()
    if not counters.get("k2.pairs") or not counters.get("k2.rows"):
        return None
    flop = 2 * 3 * counters["k2.pairs"]
    nbytes = (8 * 3 + 4) * counters["k2.rows"]
    least, _ = roofline.bound(flop, roofline.PEAK_F32, nbytes)
    return 100.0 * least / ctx["k2_device_s"]
