"""The dialog cell's work in a time window, from the stage records: tokens
delivered, prefill done, and their operations and bytes, counted from what
the inputs need (the prefix a session already holds is not prefilled
again; a token's keys are its context within the window; logits over the
stage's vocabulary slice)."""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np

from benchmark.lib import counts as C


def lcp(a, b) -> int:
    """Length of the longest common prefix of two id lists."""
    if not a or not b:
        return 0
    n = min(len(a), len(b))
    x, y = np.asarray(a[:n]), np.asarray(b[:n])
    diff = np.flatnonzero(x != y)
    return int(diff[0]) if len(diff) else n


def decoded(r) -> Iterator[Tuple[float, int]]:
    """(arrival time, position of the token fed to the step that made it)
    for each token of `r` after its first (the first comes from prefill)."""
    p, j = len(r.prompt), 0
    for t, n in r.arrivals:
        for _ in range(n):
            if j > 0:
                yield t, p + j - 1
            j += 1


def head_cols(rec: dict) -> Dict[str, int]:
    from benchmark.drivers.dialog import allow_mask

    ts = rec["tok"].ts
    return {s: int(allow_mask(s, ts).sum()) for s in ("unit2text", "text2text", "text2unit")}


def window_work(rec: dict, a: float, b: float) -> dict:
    """Work whose result reached the host in [a, b]: decode tokens and
    prefills (at their first token) -> token counts, operations by
    precision, and the paged-attention bytes and operations of the decode
    rows."""
    cfg = rec["config"]
    W, L = cfg["sliding_window"], cfg["num_hidden_layers"]
    cols = head_cols(rec)
    ops = {"int8": 0.0, "bf16": 0.0}
    k1_b = k1_o = 0.0
    n_dec = n_pre = 0
    for r in rec["requests"]:
        if not r.prompt:
            continue
        for t, pos in decoded(r):
            if a <= t <= b:
                ctx = C.keys_seen(pos, W)
                o = C.serve_token_ops(cfg, ctx, cols[r.stage])
                ops["int8"] += o["int8"]
                ops["bf16"] += o["bf16"]
                k1_b += L * C.k1_bytes(ctx, cfg)
                k1_o += L * C.k1_ops(ctx, cfg)
                n_dec += 1
        if r.t_first is not None and a <= r.t_first <= b:
            start = lcp(r.prev, r.prompt) if r.prev else 0
            n = len(r.prompt) - start
            pairs = C.causal_pairs(n, W, start)
            ops["int8"] += 2.0 * L * C.proj_params(cfg) * n
            ops["bf16"] += L * C.attn_ops(pairs, cfg) + 2.0 * cfg["hidden_size"] * cols[r.stage]
            n_pre += n
    return {"ops": ops, "k1_bytes": k1_b, "k1_ops": k1_o, "decode_tokens": n_dec,
            "prefill_tokens": n_pre}


def delta(rec: dict, key: str) -> float:
    a, b = rec["trace_stats"]
    return b[key] - a[key]
