"""W8A8 int8 quantization of the LLM and Voicebox projections.

Port of usdm_tpu/models/quant.py.  A quantized leaf is {"q": int8 [Dout,
Din], "s": bf16 [Dout]}: symmetric over the contraction axis with
per-output-channel scales, kept in the "oi" layout of K6
(ops/stream_matvec.py), where usdm_tpu keeps q as [Din, Dout].  Plain
leaves stay [Din, Dout] (`y @ w`).  `early_exit_draft` is the
self-speculation draft of the target's first layers.

`qmm(y, w)` is y @ w for either: activations are quantized per row, the
product runs int8 x int8 -> int32 exactly, and the result is
acc * ys * s in f32, cast to y's dtype.  Routes of a quantized product:
  * CPU tensors: the plain version (exact integer product);
  * CUDA, at most 16 rows (decode): K6;
  * CUDA, more rows (prefill chunks, the Voicebox estimator): the rows are
    quantized with plain torch ops and the product is torch._int_mm, a
    library int8 GEMM, as usdm_tpu leaves these products to XLA.
A CUDA shape that neither route takes raises: nothing dequantizes to float
behind the caller's back.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from usdm_tpu_torch.core.tree import tree_leaves
from usdm_tpu_torch.ops.stream_matvec import (
    MAX_ROWS,
    epilogue,
    quantize_rows,
    stream_qmv,
    stream_qmv_reference,
    symmetric_scale,
)

Params = Dict[str, Any]

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
VB_QUANT_KEYS = ("wq", "wk", "wv", "wo", "ffn_w1", "ffn_w2")


def is_quantized(w) -> bool:
    return isinstance(w, dict)


def out_dim(w) -> int:
    """Output width of a projection weight, plain [Din, Dout] or quantized."""
    return w["q"].shape[0] if is_quantized(w) else w.shape[-1]


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """w [Din, Dout] ~= q^T * s: symmetric int8 over Din, scale
    max(amax / 127, 1e-8) per output channel, round half to even."""
    wf = w.float()
    scale = symmetric_scale(wf.abs().amax(dim=0))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q.t().contiguous(), "s": scale.to(torch.bfloat16)}


def dequantize_weight(qw: Dict[str, torch.Tensor], dtype=torch.bfloat16) -> torch.Tensor:
    """-> [Din, Dout] in `dtype`."""
    return (qw["q"].t().float() * qw["s"].float()).to(dtype)


def _int_mm_ok(m: int, din: int, dout: int) -> bool:
    """torch._int_mm's shape rules on CUDA: more than 16 rows, the inner and
    output widths multiples of 8."""
    return m > MAX_ROWS and din % 8 == 0 and dout % 8 == 0


def qmm(y: torch.Tensor, w) -> torch.Tensor:
    """y [..., Din] @ w, for a plain or a quantized weight -> [..., Dout]."""
    if not is_quantized(w):
        return y @ w
    q, s = w["q"], w["s"]
    y2 = y.reshape(-1, y.shape[-1])
    m, (dout, din) = y2.shape[0], q.shape
    if y2.device.type == "cpu":
        out = stream_qmv_reference(y2, w, y.dtype)
    elif m <= MAX_ROWS:
        out = stream_qmv(y2.contiguous(), w, y.dtype)
    elif _int_mm_ok(m, din, dout):
        qy, ys = quantize_rows(y2)
        out = epilogue(torch._int_mm(qy, q.t()), ys, s, y.dtype)
    else:
        raise ValueError(f"qmm: no CUDA route for [{m}, {din}] x [{din}, {dout}]: K6 takes "
                         f"<= {MAX_ROWS} rows with Din % 16 == 0, torch._int_mm > "
                         f"{MAX_ROWS} rows with Din and Dout multiples of 8")
    return out.reshape(*y.shape[:-1], dout)


def quantize_llm_params(params: Params) -> Params:
    """Quantize every layer's projections of a Mistral param tree IN PLACE,
    layer by layer, so each float weight is freed as soon as its int8 copy
    exists (at 7B, 14 GB of bf16 and 7 GB of int8 never coexist).  embed,
    lm_head and the norms stay as they are.  Returns `params`."""
    for lp in params["layers"]:
        for k in QUANT_KEYS:
            lp[k] = quantize_weight(lp[k])
    return params


def quantize_voicebox_params(params: Params) -> Params:
    """Quantize the Voicebox estimator's per-layer projections and FFN, and
    the UNet skip combiners, IN PLACE; the embedding, proj_in/proj_out, the
    positional convs, biases and norms stay float.  Inference only: the
    trainer refuses quantized params.  Returns `params`."""
    for lp in params["layers"]:
        for k in VB_QUANT_KEYS:
            lp[k] = quantize_weight(lp[k])
    params["skip_w"] = [quantize_weight(w) for w in params["skip_w"]]
    return params


def early_exit_draft(params: Params, n_layers: int) -> Params:
    """Self-speculation draft: the target's first `n_layers` layers with the
    target's own embed, final norm and lm_head, a draft that needs no
    training or checkpoint (speculation is lossless for any draft, so this
    moves speed, never tokens).  Every tensor is the target's own, W8A8
    leaves too: nothing is copied."""
    return {"embed": params["embed"], "layers": params["layers"][:n_layers],
            "final_norm": params["final_norm"], "lm_head": params["lm_head"]}


def quantized_bytes(params: Params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))
