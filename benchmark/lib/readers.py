"""Arithmetic the per-layer readers share: shares of the traced window and
of the chip's peaks.  A reader that finds nothing to read returns None."""

from __future__ import annotations

import re

from benchmark.lib import counts as C
from benchmark.lib.peaks import PEAK_OPS_PER_S, least_time
from benchmark.lib.trace import kernel_time, union_s


def _trace(rec):
    tr = rec.get("trace")
    return tr if tr and tr.get("device_ops") else None


def idle_share(rec: dict):
    tr = _trace(rec)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def train_mfu(rec: dict):
    """The least time the card needs for the traced steps' model work (each
    precision at its published peak; recompute not counted) over the
    traced window."""
    tr = _trace(rec)
    if tr is None or rec["kind"] != "lm_train" or not rec["traced_steps"]:
        return None
    ops = C.train_step_ops(rec["config"], rec["doc_lengths"], rec["lora"])
    need = sum(v / PEAK_OPS_PER_S[k] for k, v in ops.items()) * rec["traced_steps"]
    return 100.0 * need / tr["window_s"]


FLASH = {"fwd": "flash_fwd_mma_kernel", "dq": "flash_bwd_dq_mma_kernel",
         "dkv": "flash_bwd_dkv_mma_kernel"}


def flash_roofline(rec: dict):
    """The bf16 flash kernels' (K2 forward and remat recompute, K5 dq and
    dk/dv) least time for their launches, from the packed row's valid
    pairs, over their measured time."""
    tr = _trace(rec)
    if tr is None or rec["kind"] != "lm_train":
        return None
    cfg = rec["config"]
    pairs = C.packed_pairs(rec["doc_lengths"], cfg["sliding_window"])
    ops = C.flash_ops(pairs, cfg)
    nbytes = C.flash_bytes(sum(rec["doc_lengths"]), cfg)
    need = spent = 0.0
    for part, name in FLASH.items():
        t, n = kernel_time(tr, lambda k, name=name: name in k)
        need += n * least_time(ops[part], nbytes[part], "bf16")
        spent += t
    return 100.0 * need / spent if spent else None


def copy_share(rec: dict):
    """The union of the traced steps' memory copies over the window."""
    tr = _trace(rec)
    if tr is None:
        return None
    copies = [(s, e) for n, s, e in tr["device"] if n.startswith("Memcpy")]
    return 100.0 * union_s(copies) / tr["window_s"]


def _dialog_window(rec):
    tr = _trace(rec)
    if tr is None or rec["kind"] != "dialog" or rec.get("trace_window") is None:
        return None, None
    from benchmark.lib.dialog_work import window_work

    a, b = rec["trace_window"]
    return tr, window_work(rec, a, b)


def dialog_mfu(rec: dict):
    tr, work = _dialog_window(rec)
    if tr is None:
        return None
    need = sum(v / PEAK_OPS_PER_S[k] for k, v in work["ops"].items())
    return 100.0 * need / tr["window_s"]


def k1_roofline(rec: dict):
    """Paged attention (split and combine launches): the bytes and
    operations the decode rows' contexts need, at their least time, over
    the kernels' time."""
    tr, work = _dialog_window(rec)
    if tr is None:
        return None
    t, n = kernel_time(tr, lambda k: "paged_split_kernel" in k or "paged_combine_kernel" in k)
    if not n or not work["decode_tokens"]:
        return None
    return 100.0 * least_time(work["k1_ops"], work["k1_bytes"], "bf16") / t


_INT8_GEMM = re.compile(r"gemm.*s8|s8.*gemm|imma|i8i8", re.I)


def intmm_roofline(rec: dict):
    """torch._int_mm's products (W8A8 at more than 16 rows): the least time
    of the passes the engine ran in the traced window, over the time of the
    int8 GEMM kernels (by name: eager and in graphs alike).  Each pass reads
    every projection's int8 weights once: the decode links (graph replays)
    at the rows they emitted, the eager passes (prefill chunks and mixed
    links, from the engine's counters) at the prompt rows the window's
    prefills needed."""
    tr, work = _dialog_window(rec)
    if tr is None:
        return None
    t, n = kernel_time(tr, lambda k: bool(_INT8_GEMM.search(k)))
    if not n:
        return None
    from benchmark.lib.dialog_work import delta

    links, mixed = delta(rec, "steps"), delta(rec, "mixed_links")
    eager = delta(rec, "prefill_chunks") - delta(rec, "mixed_rows") + mixed
    cfg = rec["config"]
    need = (links - mixed) * _w8a8_pass(cfg, work["decode_tokens"] / max(links, 1))
    if eager:
        need += eager * _w8a8_pass(cfg, work["prefill_tokens"] / eager)
    return 100.0 * need / t


def _w8a8_pass(cfg: dict, rows: float) -> float:
    """The least time of one pass of `rows` rows through every layer's seven
    int8 products: int8 operations at the int8 peak, or the int8 weights,
    the int8 activations and the int32 results once each."""
    g = C.dims(cfg)
    q, kv = g["H"] * g["d"], g["Hkv"] * g["d"]
    shapes = [(g["D"], q), (g["D"], kv), (g["D"], kv), (q, g["D"]), (g["D"], g["F"]),
              (g["D"], g["F"]), (g["F"], g["D"])]
    return g["L"] * sum(least_time(2.0 * rows * a * b, a * b + rows * (a + 4 * b), "int8")
                        for a, b in shapes)
