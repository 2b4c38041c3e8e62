"""dialog_tok_s: every token of the three dialog stages delivered to a
conversation inside the window, over the window's length (host clock)."""


def read(rec):
    if rec["kind"] != "dialog":
        return None
    a, b = rec["window"]
    n = sum(k for r in rec["requests"] for t, k in r.arrivals if a <= t <= b)
    return n / (b - a)
