"""intmm_roofline.dialog: the W8A8 products on torch._int_mm: the least time of the passes the engine ran in the traced window (weights read once a pass, rows from the tokens and prompts it served) over the int8 GEMM kernels' time."""

from benchmark.lib.readers import intmm_roofline


def read(rec):
    return intmm_roofline(rec)
