"""setup_s: seconds from the process's start to the first timed request or
step (loading, weights, the program's build on a first run, warm-up)."""


def read(rec):
    return rec["setup_s"]
