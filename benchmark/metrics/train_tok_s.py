"""train_tok_s: the tokens of every step run in the window, over the time
from the window's start to the end of its last step (host clock; each step
ends when its loss reaches the host)."""


def read(rec):
    if rec["kind"] != "lm_train" or not rec["steps"]:
        return None
    w0 = rec["window"][0]
    return sum(s[2] for s in rec["steps"]) / (rec["steps"][-1][1] - w0)
