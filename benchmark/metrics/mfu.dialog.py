"""mfu.dialog: the least time the card needs for the traced window's LM work (W8A8 projections at the int8 peak, attention and the stage's lm_head slice at the bf16 peak), counted from the tokens delivered and the prompts prefilled in that window, over the window."""

from benchmark.lib.readers import dialog_mfu


def read(rec):
    return dialog_mfu(rec)
