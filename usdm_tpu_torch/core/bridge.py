"""Parameter bridge: usdm_tpu pytrees (numpy leaves, as jax.device_get
returns them) -> usdm_tpu_torch parameter dicts, with every layout change,
so both packages compute the same function of the same weights.

  * stacked layer leaves [L, ...] become one dict per layer;
  * Mistral's lm_head [D, V] becomes [V, D];
  * convolutions [K, Cin/g, Cout] become PyTorch's [Cout, Cin/g, K];
  * BigVGAN's transposed convs, stored [K, Cout, Cin] with the kernel
    flipped, become ConvTranspose1d's [Cin, Cout, K];
  * quantized leaves {"q": int8 [in, out], "s": bf16 [out]} (usdm_tpu's
    models/quant.py) become the port's "oi" {"q": int8 [out, in]
    contiguous, "s": bf16 [out]};
  * LoRA adapters {target: {a: [L, in, r], b: [L, r, out], scale: [L]}}
    become one dict per layer with a 0-d scale;
  * an LM train state's Adam moments (optax's ScaleByAdamState mu/nu, or
    usdm_tpu's offload AdamWState m/v) become the port's AdamWState, one
    tensor per leaf in the port's tree_leaves order;
  * BigVGAN's discriminators' 2-D convs [KH, KW, Cin, Cout] (HWIO) become
    OIHW, and a GAN train state (generator, MPD, MRD, both optimizers'
    moments, step) the port's train/vocoder.py GanTrainState.

Imports no JAX: bf16 leaves (ml_dtypes) are widened through float32.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

Tree = Dict[str, Any]


def tensor(x, dtype: torch.dtype = None, device="cpu") -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        out = torch.from_numpy(np.ascontiguousarray(arr.astype(np.float32)))
        return out.to(device=device, dtype=dtype or torch.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _conv(w, device) -> torch.Tensor:
    return tensor(np.asarray(w, np.float32).transpose(2, 1, 0), device=device)


def _quantized(qw: Tree, i: int, device) -> Tree:
    """Entry i of a stacked quantized leaf, as the port's "oi" layout."""
    return {"q": tensor(np.asarray(qw["q"][i]).T, device=device),
            "s": tensor(qw["s"][i], torch.bfloat16, device)}


def _unstack(layers: Tree, dtype, device) -> list:
    n = len(np.asarray(next(v for v in layers.values() if not isinstance(v, dict))))
    return [{k: _quantized(v, i, device) if isinstance(v, dict) else tensor(v[i], dtype, device)
             for k, v in layers.items()} for i in range(n)]


def mistral_from_jax(jp: Tree, dtype: torch.dtype = torch.float32, device="cpu") -> Tree:
    return {
        "embed": tensor(jp["embed"], dtype, device),
        "layers": _unstack(jp["layers"], dtype, device),
        "final_norm": tensor(jp["final_norm"], dtype, device),
        "lm_head": tensor(np.asarray(jp["lm_head"], np.float32).T, dtype, device),
    }


def xlsr_from_jax(jp: Tree, device="cpu") -> Tree:
    out = {k: tensor(jp[k], device=device) for k in
           ("feat_ln_w", "feat_ln_b", "proj_w", "proj_b", "pos_conv_b", "centroids")}
    out["convs"] = [{"w": _conv(c["w"], device), "b": tensor(c["b"], device=device),
                     "ln_w": tensor(c["ln_w"], device=device),
                     "ln_b": tensor(c["ln_b"], device=device)} for c in jp["convs"]]
    out["pos_conv_w"] = _conv(jp["pos_conv_w"], device)
    out["layers"] = _unstack(jp["layers"], torch.float32, device)
    return out


def voicebox_from_jax(jp: Tree, device="cpu") -> Tree:
    out = {k: tensor(jp[k], device=device) for k in
           ("embed", "proj_in_w", "proj_in_b", "proj_out_w", "proj_out_b", "ln0_w", "ln0_b")}
    out["convpos_w"] = [_conv(w, device) for w in np.asarray(jp["convpos_w"])]
    out["convpos_b"] = [tensor(b, device=device) for b in np.asarray(jp["convpos_b"])]
    out["layers"] = _unstack(jp["layers"], torch.float32, device)
    skip_w = jp["skip_w"]
    if isinstance(skip_w, dict):
        out["skip_w"] = [_quantized(skip_w, i, device) for i in range(len(np.asarray(skip_w["s"])))]
    else:
        out["skip_w"] = [tensor(w, device=device) for w in np.asarray(skip_w)]
    out["skip_b"] = [tensor(b, device=device) for b in np.asarray(jp["skip_b"])]
    return out


def bigvgan_from_jax(jp: Tree, device="cpu") -> Tree:
    def conv_b(c, w_key="w", b_key="b"):
        return {"w": _conv(c[w_key], device), "b": tensor(c[b_key], device=device)}

    def acts(a):
        return {k: tensor(v, device=device) for k, v in a.items()}

    ups = [{"w": tensor(np.asarray(u["w"], np.float32)[::-1].transpose(2, 1, 0),
                        device=device),
            "b": tensor(u["b"], device=device)} for u in jp["ups"]]
    blocks = [{"convs1": [conv_b(c) for c in rb["convs1"]],
               "convs2": [conv_b(c) for c in rb["convs2"]],
               "acts": [acts(a) for a in rb["acts"]]} for rb in jp["resblocks"]]
    return {
        "conv_pre_w": _conv(jp["conv_pre_w"], device),
        "conv_pre_b": tensor(jp["conv_pre_b"], device=device),
        "ups": ups, "resblocks": blocks,
        "act_post": acts(jp["act_post"]),
        "conv_post_w": _conv(jp["conv_post_w"], device),
        "conv_post_b": tensor(jp["conv_post_b"], device=device),
    }


def lora_from_jax(jl: Tree, dtype: torch.dtype = torch.float32, device="cpu") -> list:
    """usdm_tpu's stacked adapters -> the port's per-layer adapters (no
    requires_grad)."""
    n = len(np.asarray(next(iter(jl.values()))["scale"]))
    return [{name: {"a": tensor(w["a"][i], dtype, device), "b": tensor(w["b"][i], dtype, device),
                    "scale": tensor(np.asarray(w["scale"])[i], dtype, device)}
             for name, w in jl.items()} for i in range(n)]


def _find_moments(opt_state):
    """(first moments, second moments, count) of an optax chain state or of
    usdm_tpu's AdamWState."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state.mu, opt_state.nu, opt_state.count
    if hasattr(opt_state, "m") and hasattr(opt_state, "v"):
        return opt_state.m, opt_state.v, opt_state.count
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _find_moments(sub)
            if found is not None:
                return found
    return None


def lm_train_state_from_jax(jstate, device="cpu"):
    """usdm_tpu's LM TrainState (host arrays: params, opt_state, step) ->
    the port's train/lm.py TrainState: f32 masters with requires_grad and
    the Adam moments in the port's leaf order and layouts."""
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.train.lm import AdamWState, TrainState

    params = mistral_from_jax(jstate.params, torch.float32, device)
    for t in tree_leaves(params):
        t.requires_grad_(True)
    mu, nu, count = _find_moments(jstate.opt_state)
    m = tree_leaves(mistral_from_jax(mu, torch.float32, device))
    v = tree_leaves(mistral_from_jax(nu, torch.float32, device))
    return TrainState(params, AdamWState(m, v, int(np.asarray(count))),
                      int(np.asarray(jstate.step)))


def _conv2d(c: Tree, device) -> Tree:
    return {"w": tensor(np.asarray(c["w"], np.float32).transpose(3, 2, 0, 1), device=device),
            "b": tensor(c["b"], device=device)}


def _disc(d: Tree, device) -> Tree:
    return {"convs": [_conv2d(c, device) for c in d["convs"]], "post": _conv2d(d["post"], device)}


def mpd_from_jax(jmpd, device="cpu") -> list:
    """usdm_tpu's period discriminators (HWIO) -> the port's (OIHW)."""
    return [_disc(d, device) for d in jmpd]


def mrd_from_jax(jmrd, device="cpu") -> list:
    """usdm_tpu's resolution discriminators (HWIO) -> the port's (OIHW)."""
    return [_disc(d, device) for d in jmrd]


def gan_train_state_from_jax(jstate, device="cpu"):
    """usdm_tpu's GanTrainState (host arrays) -> the port's: f32 params with
    requires_grad, each optimizer's Adam moments in the port's leaf order
    and layouts (the discriminators' over {"mpd", "mrd"}), counts and step."""
    from usdm_tpu_torch.core.tree import tree_leaves
    from usdm_tpu_torch.train.lm import AdamWState
    from usdm_tpu_torch.train.vocoder import GanTrainState

    def discs(pair):
        return {"mpd": mpd_from_jax(pair[0], device), "mrd": mrd_from_jax(pair[1], device)}

    def moments(opt_state, convert):
        mu, nu, count = _find_moments(opt_state)
        return AdamWState(tree_leaves(convert(mu)), tree_leaves(convert(nu)),
                          int(np.asarray(count)))

    gen = bigvgan_from_jax(jstate.gen_params, device)
    d = discs((jstate.mpd, jstate.mrd))
    for t in tree_leaves(gen) + tree_leaves(d):
        t.requires_grad_(True)
    return GanTrainState(gen, d["mpd"], d["mrd"],
                         moments(jstate.gen_opt, lambda t: bigvgan_from_jax(t, device)),
                         moments(jstate.disc_opt, discs), int(np.asarray(jstate.step)))
