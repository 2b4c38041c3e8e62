"""link_ms.dialog: milliseconds the card was busy (the union of its
operations in the profiler's window) per engine link (decode and mixed)."""

from benchmark.lib.dialog_work import delta


def read(rec):
    tr = rec.get("trace")
    if not tr or not tr.get("device_ops") or not rec.get("trace_stats"):
        return None
    links = delta(rec, "steps")
    return 1e3 * tr["busy_s"] / links if links else None
