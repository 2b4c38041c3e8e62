"""flash_roofline.lora: K2 and K5 (bf16, d 128): their least time for the packed row's valid pairs over their time."""

from benchmark.lib.readers import flash_roofline


def read(rec):
    return flash_roofline(rec)
