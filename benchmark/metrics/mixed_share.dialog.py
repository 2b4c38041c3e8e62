"""mixed_share.dialog: the share of the engine's links over the measured
window before the profiler's start that were mixed prefill + decode links
(stats(): the deltas of mixed_links and steps)."""


def read(rec):
    if rec["kind"] != "dialog":
        return None
    a, b = rec["calm_stats"]
    links = b["steps"] - a["steps"]
    return 100.0 * (b["mixed_links"] - a["mixed_links"]) / links if links else None
