"""copy_share.sft: the share of the traced steps' window in which the card copied memory (the offloaded moments' host and device copies)."""

from benchmark.lib.readers import copy_share


def read(rec):
    return copy_share(rec)
