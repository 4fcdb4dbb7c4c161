"""K2's share of its roofline: one nearest-centroid pick among all the
source's centroids per row located (``roofline.nearest_work``), over the
device time of ``nearest_centroid_kernel`` in the trace."""

from benchmark import roofline


def read(ctx):
    if not ctx["k2_device_s"] or not ctx["rows_located"]:
        return None
    flop, nbytes = roofline.nearest_work(
        ctx["rows_located"], ctx["source_elements"], ctx["dim"])
    least, _ = roofline.bound(flop, roofline.PEAK_F32, nbytes)
    return 100.0 * least / ctx["k2_device_s"]
