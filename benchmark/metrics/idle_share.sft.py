"""idle_share.sft: the share of the profiler's window in which the card
ran no kernel and no copy."""

from benchmark.lib.readers import idle_share


def read(rec):
    return idle_share(rec)
