"""LoRA: low-rank adaptation of the speech-text LM.

Port of usdm_tpu/train/lora.py (the reference's peft option: r 8, alpha 64,
targets q_proj and v_proj).  usdm_tpu stacks the adapters over layers
({target: {a: [L, in, r], b: [L, r, out], scale: [L]}}) to ride its
lax.scan; the port keeps one dict per layer, as its params:

  lora[i] = {target: {"a": [in, r], "b": [r, out], "scale": 0-d}}

every leaf an f32 master with requires_grad (scale too: usdm_tpu's optax
update trains it as a leaf), cast to the compute dtype at use
(models/mistral.py::_lora_delta).  The base stays frozen: only the adapters
receive gradients and AdamW updates.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from usdm_tpu_torch.core import mesh as MS
from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
from usdm_tpu_torch.core.tree import tree_leaves
from usdm_tpu_torch.models import mistral as M
from usdm_tpu_torch.train.lm import make_optimizer

DEFAULT_TARGETS = ("wq", "wv")  # peft's Mistral causal-LM default (q_proj, v_proj)


def _dims(cfg: MistralConfig) -> Dict[str, tuple]:
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    return {"wq": (cfg.hidden_size, q), "wk": (cfg.hidden_size, kv),
            "wv": (cfg.hidden_size, kv), "wo": (q, cfg.hidden_size)}


def init_lora(cfg: MistralConfig, generator: torch.Generator, r: int = 8, alpha: int = 64,
              targets: Sequence[str] = DEFAULT_TARGETS, device="cpu") -> List[dict]:
    """Per-layer adapters: A ~ N(0, 1/r) drawn on `device` from `generator`,
    B = 0 (the adapted model starts as the base), scale alpha / r; f32 with
    requires_grad."""
    dims = _dims(cfg)
    out = []
    for _ in range(cfg.num_layers):
        layer = {}
        for name in targets:
            din, dout = dims[name]
            a = torch.randn(din, r, generator=generator, device=device) / r**0.5
            layer[name] = {"a": a, "b": torch.zeros(r, dout, device=device),
                           "scale": torch.tensor(alpha / r, device=device)}
        out.append(layer)
    for t in tree_leaves(out):
        t.requires_grad_(True)
    return out


def merge_lora(params: dict, lora: List[dict]) -> dict:
    """Fold the adapters into the base weights (for export and serving):
    w + (A @ B * scale) in w's dtype.  Returns new layer dicts; the base's
    tensors are not modified."""
    layers = []
    with torch.no_grad():
        for lp, lw in zip(params["layers"], lora):
            lp = dict(lp)
            for name, a in lw.items():
                delta = (a["a"].float() @ a["b"].float()) * a["scale"].float()
                lp[name] = lp[name] + delta.to(lp[name].device, lp[name].dtype)
            layers.append(lp)
    return {**params, "layers": layers}


def count_lora_params(lora: List[dict]) -> int:
    return sum(t.numel() for t in tree_leaves(lora))


def make_lora_train_step(cfg: MistralConfig, tc: TrainConfig, mesh: Optional["MS.Mesh"] = None):
    """-> (step, opt); step(base, state, batch) -> {"loss", "grad_norm"}
    with `state` a train/lm.py TrainState whose params are the adapters
    (opt.init(lora) its moments), updated in place.  The base is read, never
    written: it takes no gradient.  Computes in cfg.dtype.  `mesh`: data
    parallelism, as usdm_tpu runs LoRA (base and adapters whole on every
    rank, the batch this rank's rows): the loss is the global one and the
    adapters' gradients are all-reduced (summed) over the batch axes before
    the update, so every rank updates alike."""
    opt = make_optimizer(tc)

    def step(base: dict, state, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, aux = M.loss_fn(base, cfg, batch["input_ids"], batch["labels"],
                              batch.get("segment_ids"), batch.get("positions"),
                              remat=tc.remat, lora=state.params, ce_chunk=tc.ce_chunk,
                              mesh=mesh, replicated=True)
        loss.backward()
        if mesh is not None:
            MS.all_reduce_grads(state.params, mesh)
        gnorm = opt.update(state.params, state.opt_state)
        state.step += 1
        return {"loss": aux["loss"], "grad_norm": gnorm}

    return step, opt
