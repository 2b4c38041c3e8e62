"""k1_roofline.dialog: paged attention's (K1, int8 pools) share of its roofline: the least time for the decode rows' keys and values over the kernels' time."""

from benchmark.lib.readers import k1_roofline


def read(rec):
    return k1_roofline(rec)
