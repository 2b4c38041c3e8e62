"""BigVGAN vocoder generator in PyTorch.

Port of the generator path of usdm_tpu/models/bigvgan.py: pre conv, per
stage a transposed-conv upsample and the mean of the AMP blocks, post
activation + conv + tanh.  Every AMP activation is the anti-aliased snake
(up 2x -> snake/snake-beta -> down 2x), run by the fused kernel K3
(ops/fused_act.py) when `cfg.fused_act`.  Internally channels-first
[B, C, T] with PyTorch weight layouts (Conv1d [Cout, Cin, K],
ConvTranspose1d [Cin, Cout, K]); the public `generator` takes
mel [B, n_mels, T] and returns [B, 1, T * prod(upsample_rates)] as usdm_tpu.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from usdm_tpu_torch.core.config import BigVGANConfig
from usdm_tpu_torch.ops.fused_act import activation1d_reference, fused_activation1d

Params = Dict[str, Any]


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def init_generator(cfg: BigVGANConfig, generator: torch.Generator, device="cpu") -> Params:
    """Weights N(0, 0.01), biases 0, snake alpha/beta 0 (as usdm_tpu)."""

    def w(*shape):
        return torch.randn(*shape, generator=generator, device=device) * 0.01

    def zeros(n):
        return torch.zeros(n, device=device)

    def act(c):
        a = {"alpha": zeros(c)}
        if cfg.activation == "snakebeta":
            a["beta"] = zeros(c)
        return a

    ch0 = cfg.upsample_initial_channel
    params: Params = {"conv_pre_w": w(ch0, cfg.num_mels, 7), "conv_pre_b": zeros(ch0),
                      "ups": [], "resblocks": []}
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        cin, cout = ch0 // 2**i, ch0 // 2 ** (i + 1)
        params["ups"].append({"w": w(cin, cout, k), "b": zeros(cout)})
        for kernel, dilations in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            two = cfg.resblock == "1"
            params["resblocks"].append({
                "convs1": [{"w": w(cout, cout, kernel), "b": zeros(cout)} for _ in dilations],
                "convs2": [{"w": w(cout, cout, kernel), "b": zeros(cout)}
                           for _ in dilations] if two else [],
                "acts": [act(cout) for _ in range((2 if two else 1) * len(dilations))],
            })
    ch_last = ch0 // 2 ** len(cfg.upsample_rates)
    params["act_post"] = act(ch_last)
    params["conv_post_w"] = w(1, ch_last, 7)
    params["conv_post_b"] = zeros(1)
    return params


def activation1d(x: torch.Tensor, act: Params, cfg: BigVGANConfig) -> torch.Tensor:
    """up(2x) -> snake -> down(2x) on [B, C, T]: the fused kernel when
    cfg.fused_act, else the plain composition."""
    beta = act.get("beta") if cfg.activation == "snakebeta" else None
    if cfg.fused_act:
        return fused_activation1d(x, act["alpha"], beta, cfg.snake_logscale)
    return activation1d_reference(x, act["alpha"], beta, cfg.snake_logscale)


def _amp_block(cfg: BigVGANConfig, bp: Params, x: torch.Tensor, kernel: int,
               dilations: Sequence[int]) -> torch.Tensor:
    """AMPBlock1: (act, dilated conv, act, conv) per dilation, residual;
    AMPBlock2: (act, dilated conv) per dilation, residual."""
    if cfg.resblock == "1":
        for c1, c2, a1, a2, d in zip(bp["convs1"], bp["convs2"], bp["acts"][0::2],
                                     bp["acts"][1::2], dilations):
            xt = F.conv1d(activation1d(x, a1, cfg), c1["w"], c1["b"], dilation=d,
                          padding=get_padding(kernel, d))
            xt = F.conv1d(activation1d(xt, a2, cfg), c2["w"], c2["b"],
                          padding=get_padding(kernel, 1))
            x = xt + x
    else:
        for c, a, d in zip(bp["convs1"], bp["acts"], dilations):
            x = F.conv1d(activation1d(x, a, cfg), c["w"], c["b"], dilation=d,
                         padding=get_padding(kernel, d)) + x
    return x


@torch.no_grad()
def generator(params: Params, cfg: BigVGANConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, T] -> waveform [B, 1, T * prod(upsample_rates)]."""
    x = F.conv1d(mel, params["conv_pre_w"], params["conv_pre_b"], padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        up = params["ups"][i]
        x = F.conv_transpose1d(x, up["w"], up["b"], stride=u, padding=(k - u) // 2)
        xs = None
        for j, kernel in enumerate(cfg.resblock_kernel_sizes):
            out = _amp_block(cfg, params["resblocks"][i * nk + j], x, kernel,
                             cfg.resblock_dilation_sizes[j])
            xs = out if xs is None else xs + out
        x = xs / nk
    x = activation1d(x, params["act_post"], cfg)
    x = F.conv1d(x, params["conv_post_w"], params["conv_post_b"], padding=3)
    return torch.tanh(x)


def convert_reference_state_dict(state: Dict[str, torch.Tensor], cfg: BigVGANConfig,
                                 device="cpu") -> Params:
    """The nvidia/bigvgan `generator` state dict (host tensors, popped as
    they are converted) -> the port's params on `device`, f32.  Every conv's
    torch weight norm (dim 0) is folded over its other dims in the stored
    dtype, as usdm_tpu folds it; Conv1d stays [Cout, Cin, K] and
    ConvTranspose1d [Cin, Cout, K] (usdm_tpu flips the latter's kernel for
    its dilated-conv form; the port runs conv_transpose1d and needs no
    flip).  The anti-aliasing filters in the dict are fixed by the
    architecture and not read."""
    from usdm_tpu_torch.core.convert import fold_weight_norm, take

    def conv(prefix):
        w = fold_weight_norm(state, prefix, (1, 2)).to(device, torch.float32)
        return {"w": w, "b": take(state, prefix + ".bias", device)}

    def act(prefix):
        a = {"alpha": take(state, prefix + ".act.alpha", device)}
        if cfg.activation == "snakebeta":
            a["beta"] = take(state, prefix + ".act.beta", device)
        return a

    pre = conv("conv_pre")
    params: Params = {"conv_pre_w": pre["w"], "conv_pre_b": pre["b"], "ups": [],
                      "resblocks": []}
    nk = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        params["ups"].append(conv(f"ups.{i}.0"))
        for j in range(nk):
            r = i * nk + j
            n = len(cfg.resblock_dilation_sizes[j])
            params["resblocks"].append({
                "convs1": [conv(f"resblocks.{r}.convs1.{ci}") for ci in range(n)],
                "convs2": ([conv(f"resblocks.{r}.convs2.{ci}") for ci in range(n)]
                           if cfg.resblock == "1" else []),
                "acts": [act(f"resblocks.{r}.activations.{ai}")
                         for ai in range(2 * n if cfg.resblock == "1" else n)],
            })
    params["act_post"] = act("activation_post")
    post = conv("conv_post")
    params["conv_post_w"], params["conv_post_b"] = post["w"], post["b"]
    return params
