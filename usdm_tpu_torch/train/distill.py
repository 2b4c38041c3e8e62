"""Draft-model distillation for speculative decoding, on one GPU.

Port of usdm_tpu/train/distill.py.  Speculation is lossless for any draft,
but it pays only where the draft's greedy argmax agrees with the target's,
so this trains a small Mistral with the target's vocabulary against the
target's own next-token distribution:

  * `init_draft_from_target`: the target's first N layers, embedding, final
    norm and lm_head as trainable f32 copies (quantized leaves sliced, then
    dequantized), the warm start the early-exit self-draft gives;
  * `distill_loss_fn`: tau^2 * KL(target || draft) at temperature tau, or
    (`mode="top1"`) the cross-entropy against the target's argmax, over the
    positions labelled for training (labels != -100), with `agree`, the
    argmax agreement that predicts speculative acceptance.  The target runs
    without autograd (its W8A8 leaves through qmm), the draft in bf16 from
    its f32 masters; both heads' logits are computed `chunk` positions at a
    time under torch.utils.checkpoint, so neither [T, vocab] tensor exists
    whole;
  * `make_distill_step`: that loss, then train/lm.py's clipped AdamW and
    schedule on the draft's state (TrainState, in place).

Sharded (`mesh=`, usdm_tpu's make_distill_step over its mesh): the draft's
state shards as the LM's (train/lm.py init_state(..., mesh=): FSDP over
data, TP over model, the vocab-split lm_head's chunk logits gathered), the
target stays in the layout it arrived in (whole on every rank, bf16 or
W8A8), the batch is this rank's rows, and the loss and `agree` are global
(sums over the global count of labelled positions).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from usdm_tpu_torch.core import mesh as MS
from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.models.quant import dequantize_weight, is_quantized
from usdm_tpu_torch.train import lm as T


def init_draft_from_target(params: dict, cfg: MistralConfig,
                           n_layers: int) -> Tuple[dict, MistralConfig]:
    """-> (draft params, its config): f32 copies of the target's first
    `n_layers` layers and its embed, final norm and lm_head, sharing no
    storage with the target; a quantized {"q", "s"} leaf is dequantized."""

    def copy(leaf):
        if is_quantized(leaf):
            return dequantize_weight(leaf, torch.float32)
        return leaf.detach().to(torch.float32, copy=True)

    draft = {"embed": copy(params["embed"]),
             "layers": [{k: copy(v) for k, v in lp.items()} for lp in params["layers"][:n_layers]],
             "final_norm": copy(params["final_norm"]), "lm_head": copy(params["lm_head"])}
    return draft, cfg.replace(num_layers=n_layers)


def _chunk_terms(hct, hcd, v, wt, wd, tau: float, top1: bool, mesh=None, vocab: int = 0):
    """One chunk's (loss sum, argmax agreements) from the two heads'
    logits at temperature tau (f32); `mesh`: the draft's vocab blocks are
    gathered."""
    zt = F.linear(hct, wt).float() / tau
    zd = M.lm_head_logits(hcd, wd, mesh, vocab).float() / tau
    lpt, lpd = torch.log_softmax(zt, dim=-1), torch.log_softmax(zd, dim=-1)
    top_t = zt.argmax(dim=-1)
    agree = ((top_t == zd.argmax(dim=-1)) & v).sum()
    if top1:
        tok = lpd.gather(-1, top_t[..., None])[..., 0]
        return (-tok * v).sum(), agree
    kl = (lpt.exp() * (lpt - lpd)).sum(-1)
    return (kl * v).sum(), agree


def distill_loss_fn(draft_params: dict, target_params: dict, cfg_d: MistralConfig,
                    cfg_t: MistralConfig, batch: Dict[str, torch.Tensor], *,
                    temperature: float = 1.0, mode: str = "kl", chunk: int = 512,
                    attn_impl: str = "auto", remat: bool = True,
                    mesh: Optional["MS.Mesh"] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Distillation loss and argmax agreement on one packed batch
    (input_ids, labels and optional segment_ids, positions [B, T]) ->
    (loss, {"loss", "agree", "ntokens"}).  `mesh`: the draft's params are
    its param_shardings blocks and the batch this rank's rows; `loss` is
    this rank's part of the global loss, the aux values global."""
    ids, labels = batch["input_ids"], batch["labels"]
    seg, pos = batch.get("segment_ids"), batch.get("positions")
    with torch.no_grad():
        ht = M.forward_hidden(target_params, cfg_t, ids, seg, pos, attn_impl)
    # the draft computes from its f32 masters' bf16 rounding, as usdm_tpu
    # casts them; at a bf16 compute dtype forward_hidden casts each layer
    # inside its (rematerialized) layer function, one layer's copy at a time
    dp = draft_params if cfg_d.dtype == "bfloat16" else tree_map(
        lambda w: w.to(torch.bfloat16) if w.ndim >= 2 else w, draft_params)
    hd = M.forward_hidden(dp, cfg_d, ids, seg, pos, attn_impl, remat=remat, mesh=mesh)
    # both models predict position i + 1 from the prefix up to i
    sht, shd = ht[:, :-1].to(torch.bfloat16), hd[:, :-1]
    valid = labels[:, 1:] != -100
    count = valid.sum()
    if mesh is not None:
        count = MS.all_reduce(count.clone(), mesh, mesh.batch_axes)
        shd = MS.copy_to_model(shd, mesh)
    n = count.clamp(min=1)
    wt = target_params["lm_head"].to(sht.dtype)
    wd = M.head_weight(dp, mesh, shd.dtype)
    total, agree = 0.0, 0
    for c in range(0, sht.shape[1], chunk):
        s, a = checkpoint(_chunk_terms, sht[:, c:c + chunk], shd[:, c:c + chunk],
                          valid[:, c:c + chunk], wt, wd, temperature, mode == "top1", mesh,
                          cfg_d.vocab_size, use_reentrant=False)
        total, agree = total + s, agree + a
    scale = temperature * temperature if mode == "kl" else 1.0
    loss = scale * total / n
    shown = torch.stack([loss.detach(), torch.as_tensor(agree, dtype=loss.dtype,
                                                        device=loss.device)])
    if mesh is not None:
        shown = MS.all_reduce(shown, mesh, mesh.batch_axes)
    return loss, {"loss": shown[0], "agree": shown[1] / n, "ntokens": count}


def make_distill_step(cfg_d: MistralConfig, cfg_t: MistralConfig, tc: TrainConfig, *,
                      temperature: float = 1.0, mode: str = "kl", chunk: int = 512,
                      attn_impl: str = "auto", mesh: Optional["MS.Mesh"] = None):
    """-> step(state, target_params, batch) -> {"loss", "agree",
    "grad_norm", "ntokens"} (device tensors, no synchronization), the
    draft's TrainState (train/lm.py: f32 masters, resident moments)
    updated in place by make_optimizer(tc); remat per tc.remat.  `mesh`:
    the state is init_state(..., mesh=)'s, the batch this rank's rows."""
    opt = T.make_optimizer(tc)

    def step(state: T.TrainState, target_params: dict, batch: Dict[str, torch.Tensor]):
        loss, aux = distill_loss_fn(state.params, target_params, cfg_d, cfg_t, batch,
                                    temperature=temperature, mode=mode, chunk=chunk,
                                    attn_impl=attn_impl, remat=tc.remat, mesh=mesh)
        loss.backward()
        gnorm = opt.update(state.params, state.opt_state, state.layout)
        state.step += 1
        return {"loss": aux["loss"], "agree": aux["agree"], "grad_norm": gnorm,
                "ntokens": aux["ntokens"]}

    return step
