"""mfu.lora: the least time the card needs for the traced steps' model work (bf16 peak; the frozen base's forward and input gradient 4 N T, attention, the adapters) over the traced window."""

from benchmark.lib.readers import train_mfu


def read(rec):
    return train_mfu(rec)
