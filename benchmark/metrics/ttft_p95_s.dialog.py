"""ttft_p95_s.dialog: the nearest-rank 95th percentile, over every stage
request submitted inside the measured window before the profiler's start
(the traced run's profiler stalls the engine when it stops), of the seconds
from its submission to its first token (host clock); a request that never
got one counts as infinite."""

from benchmark.lib.stats import percentile


def read(rec):
    if rec["kind"] != "dialog":
        return None
    a, b = rec["calm"]
    waits = [(r.t_first - r.t_submit) if r.t_first is not None else float("inf")
             for r in rec["requests"] if a <= r.t_submit < b]
    return percentile(waits, 95) if waits else None
