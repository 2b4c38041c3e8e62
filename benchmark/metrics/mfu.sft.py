"""mfu.sft: the least time the card needs for the traced steps' model work (bf16 peak; full training 6 N T plus attention) over the traced window."""

from benchmark.lib.readers import train_mfu


def read(rec):
    return train_mfu(rec)
