"""Operations and bytes of the LM's work, counted from shapes and from what
the inputs need: valid keys within each document and window, the prefix a
session already holds, the vocabulary slice a stage decodes over.  Sizes
come from a configuration file's HF keys (`hidden_size`, ...)."""

from __future__ import annotations

from typing import Dict, Sequence


def dims(cfg: dict) -> Dict[str, int]:
    return {"D": cfg["hidden_size"], "F": cfg["intermediate_size"],
            "L": cfg["num_hidden_layers"], "H": cfg["num_attention_heads"],
            "Hkv": cfg["num_key_value_heads"], "d": cfg["head_dim"],
            "V": cfg["vocab_size"], "W": cfg["sliding_window"]}


def proj_params(cfg: dict) -> int:
    """Weights of one layer's seven projections (q, k, v, o, gate, up, down)."""
    g = dims(cfg)
    q, kv = g["H"] * g["d"], g["Hkv"] * g["d"]
    return g["D"] * q + 2 * g["D"] * kv + q * g["D"] + 3 * g["D"] * g["F"]


def keys_seen(pos: int, window: int) -> int:
    """Keys a query at 0-based position `pos` attends to, causally, within
    the window rule q - k <= window."""
    return min(pos + 1, window + 1)


def causal_pairs(n: int, window: int, start: int = 0) -> int:
    """(query, key) pairs of queries at positions start .. start + n - 1
    over a causal context from position 0, windowed."""
    w1 = window + 1

    def upto(m):  # sum over pos < m of min(pos + 1, w1)
        if m <= w1:
            return m * (m + 1) // 2
        return w1 * (w1 + 1) // 2 + (m - w1) * w1

    return upto(start + n) - upto(start)


def packed_pairs(doc_lengths: Sequence[int], window: int) -> int:
    """Pairs of one packed row whose documents attend only to themselves."""
    return sum(causal_pairs(n, window) for n in doc_lengths)


def attn_ops(pairs: int, cfg: dict) -> float:
    """Q.K^T and P.V over every query head, one layer: 4 * pairs * H * d."""
    g = dims(cfg)
    return 4.0 * pairs * g["H"] * g["d"]


# ---------------------------------------------------------------- kernels
def flash_ops(pairs: int, cfg: dict) -> Dict[str, float]:
    """Operations of one layer's flash attention kernels over `pairs`, the
    repository's convention (chip_smoke.py's K2/K5 bounds): forward 2
    products, dq 3, dk/dv 4, each 2 * d operations a pair and head."""
    g = dims(cfg)
    per = 2.0 * g["d"] * pairs * g["H"]
    return {"fwd": 2 * per, "dq": 3 * per, "dkv": 4 * per}


def flash_bytes(tokens: int, cfg: dict, elem: int = 2) -> Dict[str, float]:
    """Bytes one layer's flash kernels read and write at least: q and o (and
    their gradients), k and v (and theirs), each once."""
    g = dims(cfg)
    q = tokens * g["H"] * g["d"] * elem
    kv = tokens * g["Hkv"] * g["d"] * elem
    return {"fwd": 2 * q + 2 * kv, "dq": 3 * q + 2 * kv + q, "dkv": 3 * q + 2 * kv + 2 * kv}


def k1_bytes(ctx: int, cfg: dict, kv_elem: int = 1, scale_elem: int = 4) -> float:
    """Bytes one decode row's paged attention needs at one layer: its `ctx`
    keys and values (int8 with an f32 scale per token and kv head), the
    query read and the output written (bf16)."""
    g = dims(cfg)
    return (ctx * g["Hkv"] * 2 * (g["d"] * kv_elem + scale_elem)
            + 2 * g["H"] * g["d"] * 2)


def k1_ops(ctx: int, cfg: dict) -> float:
    g = dims(cfg)
    return 4.0 * ctx * g["H"] * g["d"]


# ---------------------------------------------------------------- model work
def train_step_ops(cfg: dict, doc_lengths: Sequence[int], lora: dict = None) -> Dict[str, float]:
    """Model operations of one training step on a packed row, by precision
    (all bf16 products here).  Full training: forward 2 N T, backward 4 N T
    over the products' weights N (projections and lm_head), attention 4 P H
    d forward and twice that backward, per layer.  LoRA (`lora` = {"r",
    "targets": {name: (din, dout)}}): the frozen base needs the backward to
    its inputs only (2 N T), the adapters forward and backward.  Remat's
    recompute is not counted."""
    g = dims(cfg)
    t = sum(doc_lengths)
    n_mm = g["L"] * proj_params(cfg) + g["V"] * g["D"]
    attn = g["L"] * attn_ops(packed_pairs(doc_lengths, g["W"]), cfg)
    if lora is None:
        return {"bf16": 6.0 * n_mm * t + 3.0 * attn}
    adapters = g["L"] * sum(lora["r"] * (din + dout) for din, dout in lora["targets"].values())
    return {"bf16": 4.0 * n_mm * t + 3.0 * attn + 6.0 * adapters * t}


def serve_token_ops(cfg: dict, ctx: int, head_cols: int) -> Dict[str, float]:
    """One token through the W8A8 LM at context `ctx` (keys it attends to,
    itself included): the projections in int8, attention and, where a
    token's logits are computed, `head_cols` lm_head columns in bf16."""
    g = dims(cfg)
    return {"int8": 2.0 * g["L"] * proj_params(cfg),
            "bf16": g["L"] * 4.0 * ctx * g["H"] * g["d"] + 2.0 * g["D"] * head_cols}
