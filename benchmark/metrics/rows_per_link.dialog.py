"""rows_per_link.dialog: the tokens the engine emitted per link (decode and
mixed) over the measured window before the profiler's start, from its
counters (stats(): the deltas of total_emitted and steps)."""


def read(rec):
    if rec["kind"] != "dialog":
        return None
    a, b = rec["calm_stats"]
    links = b["steps"] - a["steps"]
    return (b["total_emitted"] - a["total_emitted"]) / links if links else None
