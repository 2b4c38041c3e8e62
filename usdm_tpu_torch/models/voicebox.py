"""token-Voicebox: conditional-flow-matching mel generator in PyTorch.

Port of usdm_tpu/models/voicebox.py: the non-causal transformer estimator
(unit embedding + noisy mel + cond mel -> projection; sinusoidal flow time
prepended as a pseudo-token; grouped-conv positional embeddings; symmetric
ALiBi with column 0 exempt; post-LN layers with UNet skips), the OT-CFM
training loss, and Heun/Euler ODE sampling with classifier-free guidance by
batch doubling and an optional speech prompt (a reference mel re-noised
after every solver stage).  Parameters: a dict of tensors, positional convs in PyTorch's
[Cout, Cin/g, K] layout, one dict per layer, one skip combiner per up layer.

The estimator computes in the dtype of `params["proj_in_w"]` and casts every
floating parameter and input to it, as usdm_tpu does, so a trainer may cast
only the large weights (bf16 compute over f32 masters).  The per-layer
projections and FFN and the skip combiners may be W8A8 quantized leaves
(models/quant.py `quantize_voicebox_params`, inference only): every product
with them goes through `qmm`, and the cast widens their scales and leaves
the int8 values.  The attention takes
the flash kernels (K2 forward, K5 backward; ALiBi in-kernel) on CUDA when
T + 1 >= 128 and the head count is a power of 2, as usdm_tpu does on a TPU;
otherwise the plain path with the bias materialized.  The residual + mask +
LayerNorm steps take the fused kernel (K4) on CUDA when H % 128 == 0 and
B * (T + 1) >= 3072, usdm_tpu's gate: training batches pass it, and so
does respond()'s CFG batch of 2 once a speaker reference makes T + 1 >=
1536 (a reference of about 12 s or more).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from usdm_tpu_torch.core.config import VoiceboxConfig
from usdm_tpu_torch.core.tree import tree_map
from usdm_tpu_torch.models.quant import is_quantized, qmm
from usdm_tpu_torch.models.xlsr import layer_norm
from usdm_tpu_torch.ops import conv as CV
from usdm_tpu_torch.ops.attention import plain_attention
from usdm_tpu_torch.ops.flash_attention import flash_attention
from usdm_tpu_torch.ops.fused_ln import add_mask_ln

Params = Dict[str, Any]


def alibi_slopes(n_heads: int) -> np.ndarray:
    """ALiBi head slopes (xformers formula)."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * start**i for i in range(n)]

    if math.log2(n_heads).is_integer():
        return np.asarray(pow2(n_heads), np.float32)
    closest = 2 ** math.floor(math.log2(n_heads))
    extra = alibi_slopes(2 * closest)[0::2][: n_heads - closest]
    return np.asarray(pow2(closest) + list(extra), np.float32)


def sinusoidal_time_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """[B] -> [B, dim]: concat(sin, cos) with freq base log(10000)/(dim/2 - 1)."""
    half = dim // 2
    freqs = np.exp(np.arange(half, dtype=np.float32) * -(math.log(10000.0) / (half - 1)))
    ang = scale * t[:, None].float() * torch.from_numpy(freqs.astype(np.float32)).to(t.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(cfg: VoiceboxConfig, generator: torch.Generator, device="cpu") -> Params:
    """Random weights with the JAX init's distributions, from `generator`."""
    H, F_, E, nf, L = (cfg.hidden_size, cfg.intermediate_size, cfg.embedding_dim,
                       cfg.n_feats, cfg.num_layers)
    g, w = cfg.convpos_groups, cfg.convpos_width

    def dense(fan_in, *shape):
        bound = 1.0 / math.sqrt(fan_in)
        return (torch.rand(*shape, generator=generator, device=device) * 2.0 - 1.0) * bound

    def zeros(*shape):
        return torch.zeros(*shape, device=device)

    def ones(*shape):
        return torch.ones(*shape, device=device)

    layers = [{
        "wq": dense(H, H, H), "bq": zeros(H), "wk": dense(H, H, H), "bk": zeros(H),
        "wv": dense(H, H, H), "bv": zeros(H), "wo": dense(H, H, H), "bo": zeros(H),
        "ln1_w": ones(H), "ln1_b": zeros(H),
        "ffn_w1": dense(H, H, F_), "ffn_b1": zeros(F_),
        "ffn_w2": dense(F_, F_, H), "ffn_b2": zeros(H),
        "ln2_w": ones(H), "ln2_b": zeros(H),
    } for _ in range(L)]
    return {
        "embed": torch.randn(cfg.n_tokens + 1, E, generator=generator, device=device),
        "proj_in_w": dense(2 * nf + E, 2 * nf + E, H), "proj_in_b": zeros(H),
        "proj_out_w": dense(H, H, nf), "proj_out_b": zeros(nf),
        "convpos_w": [dense(H * w // g, H, H // g, w) for _ in range(cfg.convpos_depth)],
        "convpos_b": [zeros(H) for _ in range(cfg.convpos_depth)],
        "ln0_w": ones(H), "ln0_b": zeros(H),
        "layers": layers,
        "skip_w": [dense(2 * H, 2 * H, H) for _ in range(L // 2)],
        "skip_b": [zeros(H) for _ in range(L // 2)],
    }


def _attention(lp: Params, x: torch.Tensor, n_heads: int, bias=None, flash_ctx=None):
    """Post-LN MHA; flash_ctx = (segments, positions) selects the kernel."""
    b, t, hdim = x.shape
    d = hdim // n_heads
    q = (qmm(x, lp["wq"]) + lp["bq"]).reshape(b, t, n_heads, d)
    k = (qmm(x, lp["wk"]) + lp["bk"]).reshape(b, t, n_heads, d)
    v = (qmm(x, lp["wv"]) + lp["bv"]).reshape(b, t, n_heads, d)
    if flash_ctx is not None:
        seg, pos = flash_ctx
        out = flash_attention(q, k, v, seg, seg, pos, pos, causal=False, sliding_window=None,
                              scale=d**-0.5, alibi=True)
    else:  # q scaled before the dot, additive bias = masked ALiBi + pad penalty
        out = plain_attention(q * (d**-0.5), k, v, None, bias=bias, scale=1.0)
    return qmm(out.reshape(b, t, hdim), lp["wo"]) + lp["bo"]


def _ffn(lp: Params, h: torch.Tensor) -> torch.Tensor:
    return qmm(F.gelu(qmm(h, lp["ffn_w1"]) + lp["ffn_b1"]), lp["ffn_w2"]) + lp["ffn_b2"]


def _encoder_layer(cfg, lp, x, y_mask, bias, flash_ctx, ln_lengths=None):
    """residual attn -> mask -> LN -> +FFN -> mask -> LN -> mask; with
    `ln_lengths` each residual + mask + LN runs as one fused pass (K4)."""
    x = x * y_mask
    attn = _attention(lp, x, cfg.num_heads, bias, flash_ctx)
    if ln_lengths is not None:
        h = add_mask_ln(x, attn, ln_lengths, lp["ln1_w"], lp["ln1_b"])
        ff = _ffn(lp, h)
        return add_mask_ln(h, ff, ln_lengths, lp["ln2_w"], lp["ln2_b"], post_mask=True)
    h = (x + attn) * y_mask
    h = layer_norm(h, lp["ln1_w"], lp["ln1_b"])
    ff = _ffn(lp, h)
    h = layer_norm((h + ff) * y_mask, lp["ln2_w"], lp["ln2_b"])
    return h * y_mask


def _conv_pos_embed(w, b, x, y_mask, groups, width):
    """Grouped same-conv + GELU + mask on [B, T, H]."""
    pad = (width // 2, width // 2 - (1 if width % 2 == 0 else 0))
    out = CV.conv(F.pad(x.transpose(1, 2), pad), w, b, groups=groups).transpose(1, 2)
    return F.gelu(out) * y_mask


def estimator(params: Params, cfg: VoiceboxConfig, x_units: torch.Tensor, y: torch.Tensor,
              cond: torch.Tensor, t: torch.Tensor, lengths: torch.Tensor,
              remat: bool = False, attn_impl: str = "auto",
              fused_ln: str = "auto") -> torch.Tensor:
    """Vector field u(x, y, cond, t): units [B, T], y/cond [B, n_feats, T],
    t/lengths [B] -> [B, n_feats, T] in the params' compute dtype.

    remat: recompute each layer in the backward pass (training at 16 s crops
    needs it).  attn_impl: auto | flash | plain.  fused_ln: auto | fused |
    plain."""
    b, T = x_units.shape
    H = cfg.hidden_size
    dev = y.device
    cdt = params["proj_in_w"].dtype  # compute dtype follows the params
    params = tree_map(lambda a: a.to(cdt) if a.is_floating_point() else a, params)
    emb = params["embed"][x_units] * math.sqrt(cfg.embedding_dim)
    feats = torch.cat([emb, y.transpose(1, 2).to(cdt), cond.transpose(1, 2).to(cdt)], dim=-1)
    h = feats @ params["proj_in_w"] + params["proj_in_b"]
    t_tok = sinusoidal_time_emb(t.reshape(b), H).to(cdt)[:, None]
    h = torch.cat([t_tok, h], dim=1)  # time token
    T1 = T + 1
    lengths1 = lengths + 1
    valid = torch.arange(T1, device=dev)[None] < lengths1[:, None]  # [B, T1]
    y_mask = valid.to(h.dtype)[:, :, None]
    h = h * y_mask

    pow2_heads = cfg.num_heads & (cfg.num_heads - 1) == 0
    if attn_impl == "auto":
        use_flash = h.is_cuda and T1 >= 128 and pow2_heads
    else:
        use_flash = attn_impl == "flash"
    flash_ctx, bias = None, None
    if use_flash:
        # int32 and contiguous, as the kernels read them: made once here, not
        # converted again by each of the layers' calls
        flash_ctx = (torch.where(valid, 0, -1).to(torch.int32),
                     torch.arange(T1, device=dev, dtype=torch.int32)[None].expand(b, T1)
                     .contiguous())
    else:  # ALiBi with key column 0 exempt, pad columns masked (as usdm_tpu)
        slopes = torch.from_numpy(-alibi_slopes(cfg.num_heads)).to(dev)
        ar = torch.arange(T1, device=dev)
        alibi = slopes[:, None, None] * (ar[None, :] - ar[:, None]).abs().float()[None]
        alibi[:, :, 0] = 0.0
        alibi_bias = alibi[None] * y_mask[:, :, 0][:, None, None, :]
        pad_bias = torch.where(valid[:, None, None, :], 0.0, torch.finfo(h.dtype).min)
        bias = alibi_bias + pad_bias
    if fused_ln == "auto":
        use_fused = h.is_cuda and H % 128 == 0 and b * T1 >= 3072
    else:
        use_fused = fused_ln == "fused"

    pos_res = h
    for w, bb in zip(params["convpos_w"], params["convpos_b"]):
        h = _conv_pos_embed(w, bb, h, y_mask, cfg.convpos_groups, cfg.convpos_width)
    h = layer_norm(h + pos_res, params["ln0_w"], params["ln0_b"]) * y_mask

    # K4 reads int32 lengths: cast once here, not in each of its calls
    ln_lengths = lengths1.to(torch.int32) if use_fused else None
    layer = functools.partial(_encoder_layer, cfg, y_mask=y_mask, bias=bias,
                              flash_ctx=flash_ctx, ln_lengths=ln_lengths)
    if remat:
        layer = functools.partial(checkpoint, layer, use_reentrant=False)
    half = cfg.num_layers // 2
    skips = []
    for lp in params["layers"][:half]:  # down path: each layer's INPUT is a skip
        skips.append(h)
        h = layer(lp, h)
    for i, lp in enumerate(params["layers"][half:]):  # up path pops them LIFO
        h = qmm(torch.cat([h, skips.pop()], dim=-1), params["skip_w"][i]) + params["skip_b"][i]
        h = layer(lp, h)

    out = ((h * y_mask) @ params["proj_out_w"] + params["proj_out_b"]) * y_mask
    return out.transpose(1, 2)[:, :, 1:]  # drop the time token


def cfm_loss(params: Params, cfg: VoiceboxConfig, x_units: torch.Tensor, mask: torch.Tensor,
             x1: torch.Tensor, lengths: torch.Tensor, t: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None, generator: Optional[torch.Generator] = None,
             remat: bool = True,
             frames: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """OT-CFM loss on non-context frames: y = (1 - (1 - sigma) t) z + t x1,
    target u = x1 - (1 - sigma) z, cond = x1 * mask, MSE over valid and
    non-context frames.  units [B, T], mask [B, 1, T] (1 = context frame),
    x1 [B, n_feats, T] target mel, lengths [B]; t [B] and z (x1's shape) are
    given or drawn from `generator`.  `frames` maps this batch's count of
    loss frames to the denominator's (a data-parallel step's global count;
    default: this batch's)."""
    if is_quantized(params["layers"][0]["wq"]):
        raise ValueError("quantized Voicebox params are inference-only")
    b, nf, T = x1.shape
    if t is None:
        t = torch.rand(b, generator=generator, device=x1.device, dtype=x1.dtype)
    if z is None:
        z = torch.randn(x1.shape, generator=generator, device=x1.device, dtype=x1.dtype)
    t3 = t[:, None, None]
    loss_mask = (torch.arange(T, device=x1.device)[None, :] < lengths[:, None]).to(x1.dtype)[:, None]
    y = (1.0 - (1.0 - cfg.sigma_min) * t3) * z + t3 * x1
    cond = x1 * mask
    u = x1 - (1.0 - cfg.sigma_min) * z
    ue = estimator(params, cfg, x_units, y, cond, t, lengths, remat=remat)
    loss_mask = loss_mask * (1.0 - mask)
    diff = (ue - u) * loss_mask
    nframes = loss_mask.sum() if frames is None else frames(loss_mask.sum())
    denom = torch.clamp(nframes * nf, min=1.0)
    loss = (diff * diff).sum() / denom
    return loss, {"loss": loss, "nframes": nframes}


def _cfg_estimate(params, cfg, x, z, cond, lengths, t, gradient_scale, fused_ln="auto"):
    """CFG by batch doubling: rows [0, b) unconditional (null units, zero
    cond), rows [b, 2b) conditional; (1 + s) c - s u."""
    if gradient_scale <= 0:
        return estimator(params, cfg, x, z, cond, t, lengths, fused_ln=fused_ln)
    b = x.shape[0]
    d = estimator(params, cfg, torch.cat([torch.full_like(x, cfg.n_tokens), x]),
                  torch.cat([z, z]), torch.cat([torch.zeros_like(cond), cond]),
                  torch.cat([t, t]), torch.cat([lengths, lengths]), fused_ln=fused_ln)
    d_un, d_cond = d[:b], d[b:]
    return d_cond + gradient_scale * (d_cond - d_un)


def _renoise_prompt(z: torch.Tensor, cond: torch.Tensor, t, prompt_len: int, sigma_min: float,
                    noise: torch.Tensor) -> torch.Tensor:
    """Re-noise the prompt frames [0, prompt_len) of z to flow time t: (1 -
    (1 - sigma_min) t) noise + t cond there, z elsewhere.  The coefficient
    is computed in f32, as usdm_tpu computes it from its f32 time grid."""
    t = np.float32(t)
    coef = np.float32(1.0) - np.float32(1.0 - sigma_min) * t
    prompt = float(coef) * noise + float(t) * cond
    frame = torch.arange(z.shape[-1], device=z.device)[None, None, :]
    return torch.where(frame < prompt_len, prompt, z)


@torch.no_grad()
def generate(params: Params, cfg: VoiceboxConfig, x_units: torch.Tensor, cond: torch.Tensor,
             lengths: torch.Tensor, n_timesteps: int = 50, solver: str = "heun",
             gradient_scale: float = 1.0, z: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, speech_prompt: bool = False,
             prompt_len: int = 0, prompt_noises: Optional[torch.Tensor] = None,
             fused_ln: str = "auto") -> torch.Tensor:
    """Sample mel [B, n_feats, T] by solving the probability-flow ODE from
    z ~ N(0, I).  Heun takes (n + 1) // 2 steps with no corrector on the
    last.  Without a speech prompt `cond` is zeroed, as usdm_tpu does.

    With `speech_prompt`, `cond` holds the reference mel in frames [0,
    prompt_len) and is kept; the prompt frames are re-noised to the step's
    end time after the predictor with prompt_noises[i, 0] and after the
    corrector with prompt_noises[i, 1] (Euler: after each step with [i,
    0]).  `prompt_noises` is [n_steps, 2, *cond.shape].

    `z` and `prompt_noises` are given, or drawn from `generator` in this
    order: z (cond's shape), then all of prompt_noises in one draw.
    `fused_ln` is the estimator's."""
    if solver not in ("heun", "euler"):
        raise ValueError(f"unknown solver {solver!r}")
    cond = cond.float() if speech_prompt else torch.zeros_like(cond, dtype=torch.float32)
    if z is None:
        z = torch.randn(cond.shape, generator=generator, device=cond.device)
    z = z.float()
    n_steps = (n_timesteps + 1) // 2 if solver == "heun" else n_timesteps
    if speech_prompt and prompt_noises is None:
        prompt_noises = torch.randn((n_steps, 2, *cond.shape), generator=generator,
                                    device=cond.device)
    ts = torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32).tolist()
    b = z.shape[0]

    def est(zz, tt):
        tb = torch.full((b,), tt, dtype=torch.float32, device=zz.device)
        return _cfg_estimate(params, cfg, x_units, zz, cond, lengths, tb, gradient_scale,
                             fused_ln).float()

    def renoise(zz, t, i, j):
        if not speech_prompt:
            return zz
        return _renoise_prompt(zz, cond, t, prompt_len, cfg.sigma_min,
                               prompt_noises[i, j].float())

    for i in range(n_steps):
        t0, t1 = ts[i], ts[i + 1]
        dt = np.float32(t1) - np.float32(t0)
        dphi = est(z, t0)
        z_hat = renoise(z + float(dt) * dphi, t1, i, 0)
        if solver == "heun" and i < n_steps - 1:
            z = renoise(z + float(dt) * (dphi + est(z_hat, t1)) / 2.0, t1, i, 1)
        else:  # Euler, and Heun's final step, which skips the corrector
            z = z_hat
    return z


def convert_reference_state_dict(state: Dict[str, torch.Tensor], cfg: VoiceboxConfig,
                                 device="cpu") -> Params:
    """The reference Voicebox state dict (HubMixin `estimator.*` keys; host
    tensors, popped as they are converted) -> the port's params on `device`,
    f32: nn.Linear [out, in] -> [in, out], the 1x1 convs proj_in/proj_out
    [out, in, 1] -> dense [in, out], the positional convs kept as
    [out, in/g, w] with torch's weight norm (dim 2) folded over dims (0, 1)
    in the stored dtype, as usdm_tpu folds it."""
    from usdm_tpu_torch.core.convert import fold_weight_norm, take, take_linear

    pre = "estimator."

    def f32(name):
        return take(state, pre + name, device)

    def lin(name):
        return take_linear(state, pre + name + ".weight", device)

    def conv1x1(name):
        return take(state, pre + name + ".weight", device)[:, :, 0].t().contiguous()

    out = {"embed": f32("embed.weight"),
           "proj_in_w": conv1x1("proj_in"), "proj_in_b": f32("proj_in.bias"),
           "proj_out_w": conv1x1("proj_out"), "proj_out_b": f32("proj_out.bias"),
           "convpos_w": [fold_weight_norm(state, pre + f"pos_conv_embeds.{i}.conv", (0, 1))
                         .to(device, torch.float32) for i in range(cfg.convpos_depth)],
           "convpos_b": [f32(f"pos_conv_embeds.{i}.conv.bias")
                         for i in range(cfg.convpos_depth)],
           "ln0_w": f32("layer_norm.weight"), "ln0_b": f32("layer_norm.bias")}
    layers = []
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        lp = {}
        for w, b, n in (("wq", "bq", "attention.q_proj"), ("wk", "bk", "attention.k_proj"),
                        ("wv", "bv", "attention.v_proj"), ("wo", "bo", "attention.out_proj"),
                        ("ffn_w1", "ffn_b1", "feed_forward.intermediate_dense"),
                        ("ffn_w2", "ffn_b2", "feed_forward.output_dense")):
            lp[w], lp[b] = lin(p + n), f32(p + n + ".bias")
        lp.update(ln1_w=f32(p + "layer_norm.weight"), ln1_b=f32(p + "layer_norm.bias"),
                  ln2_w=f32(p + "final_layer_norm.weight"),
                  ln2_b=f32(p + "final_layer_norm.bias"))
        layers.append(lp)
    out["layers"] = layers
    nh = cfg.num_layers // 2
    out["skip_w"] = [lin(f"skip_connections_layers.{i}") for i in range(nh)]
    out["skip_b"] = [f32(f"skip_connections_layers.{i}.bias") for i in range(nh)]
    return out
