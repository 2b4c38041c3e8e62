"""BigVGAN vocoder in PyTorch: the generator, and the discriminators and
GAN losses that train it.

Port of usdm_tpu/models/bigvgan.py: pre conv, per stage a transposed-conv
upsample and the mean of the AMP blocks, post activation + conv + tanh.
Every AMP activation is the anti-aliased snake (up 2x -> snake/snake-beta ->
down 2x), run by the fused kernel K3 (ops/fused_act.py, differentiable) when
`cfg.fused_act`.  Internally channels-first [B, C, T] with PyTorch weight
layouts (Conv1d [Cout, Cin, K], ConvTranspose1d [Cin, Cout, K], Conv2d
OIHW); `generator` (inference, no autograd) and `forward` (the trainer's)
take mel [B, n_mels, T] and return [B, 1, T * prod(upsample_rates)] as
usdm_tpu.  The multi-period (MPD) and multi-resolution (MRD)
discriminators run on [B, 1, T] waveforms, their feature maps NCHW.  Every
convolution goes through ops/conv.py (f32 without TF32 on the card).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F

from usdm_tpu_torch.core.config import BigVGANConfig
from usdm_tpu_torch.ops import conv as CV
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
            xt = CV.conv(activation1d(x, a1, cfg), c1["w"], c1["b"], dilation=d,
                      padding=get_padding(kernel, d))
            xt = CV.conv(activation1d(xt, a2, cfg), c2["w"], c2["b"],
                      padding=get_padding(kernel, 1))
            x = xt + x
    else:
        for c, a, d in zip(bp["convs1"], bp["acts"], dilations):
            x = CV.conv(activation1d(x, a, cfg), c["w"], c["b"], dilation=d,
                     padding=get_padding(kernel, d)) + x
    return x


def forward(params: Params, cfg: BigVGANConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, T] -> waveform [B, 1, T * prod(upsample_rates)],
    differentiable (the GAN trainer's generator)."""
    x = CV.conv(mel, params["conv_pre_w"], params["conv_pre_b"], padding=3)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        up = params["ups"][i]
        x = CV.conv(x, up["w"], up["b"], stride=u, padding=(k - u) // 2, transposed=True)
        xs = None
        for j, kernel in enumerate(cfg.resblock_kernel_sizes):
            out = _amp_block(cfg, params["resblocks"][i * nk + j], x, kernel,
                             cfg.resblock_dilation_sizes[j])
            xs = out if xs is None else xs + out
        x = xs / nk
    x = activation1d(x, params["act_post"], cfg)
    x = CV.conv(x, params["conv_post_w"], params["conv_post_b"], padding=3)
    return torch.tanh(x)


@torch.no_grad()
def generator(params: Params, cfg: BigVGANConfig, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, T] -> waveform [B, 1, T * prod(upsample_rates)]."""
    return forward(params, cfg, mel)


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


# ---------------------------------------------------------------------------
# Discriminators and GAN losses (usdm_tpu/models/bigvgan.py:366-540)
# ---------------------------------------------------------------------------

DEFAULT_PERIODS = (2, 3, 5, 7, 11)
DEFAULT_RESOLUTIONS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))
MRD_STRIDES = ((1, 1), (1, 2), (1, 2), (1, 2), (1, 1))


def _normal(generator: torch.Generator, device, *shape) -> torch.Tensor:
    return torch.randn(*shape, generator=generator, device=device) * 0.02


def init_period_discriminator(generator: torch.Generator, d_mult: int = 1,
                              kernel_size: int = 5, device="cpu") -> Params:
    """DiscriminatorP's convs, OIHW: five (k, 1) convs 1 -> 32 -> 128 -> 512
    -> 1024 -> 1024 (times d_mult) and a (3, 1) post conv to one channel;
    weights N(0, 0.02^2), biases 0."""
    chans = [1] + [int(c * d_mult) for c in (32, 128, 512, 1024, 1024)]
    convs = [{"w": _normal(generator, device, chans[i + 1], chans[i], kernel_size, 1),
              "b": torch.zeros(chans[i + 1], device=device)} for i in range(5)]
    post = {"w": _normal(generator, device, 1, chans[-1], 3, 1),
            "b": torch.zeros(1, device=device)}
    return {"convs": convs, "post": post}


def _leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def period_discriminator(dp: Params, wav: torch.Tensor, period: int, kernel_size: int = 5,
                         stride: int = 3):
    """wav [B, 1, T] -> (score [B, N], feature maps [B, C, H, W]): T
    reflect-padded to a multiple of the period, viewed as [B, 1, T/p, p],
    then strided (k, 1) convs with leaky ReLU 0.1."""
    b, _, t = wav.shape
    if t % period:
        wav = F.pad(wav, (0, period - t % period), mode="reflect")
        t = wav.shape[-1]
    x = wav.reshape(b, 1, t // period, period)
    fmap = []
    pad = (kernel_size - 1) // 2
    for i, c in enumerate(dp["convs"]):
        x = _leaky_relu(CV.conv(x, c["w"], c["b"], stride=(stride, 1) if i < 4 else (1, 1),
                             padding=(pad, 0) if i < 4 else (2, 0)))
        fmap.append(x)
    x = CV.conv(x, dp["post"]["w"], dp["post"]["b"], padding=(1, 0))
    fmap.append(x)
    return x.reshape(b, -1), fmap


def init_mpd(generator: torch.Generator, periods: Sequence[int] = DEFAULT_PERIODS,
             d_mult: int = 1, device="cpu") -> list:
    return [init_period_discriminator(generator, d_mult, device=device) for _ in periods]


def init_resolution_discriminator(generator: torch.Generator, d_mult: int = 1,
                                  device="cpu") -> Params:
    """DiscriminatorR's convs, OIHW: (3, 9) 1 -> 32, three (3, 9) 32 -> 32,
    (3, 3) 32 -> 32 (times d_mult), a (3, 3) post conv to one channel."""
    c = int(32 * d_mult)
    shapes = [((3, 9), 1), ((3, 9), c), ((3, 9), c), ((3, 9), c), ((3, 3), c)]
    convs = [{"w": _normal(generator, device, c, cin, kh, kw), "b": torch.zeros(c, device=device)}
             for (kh, kw), cin in shapes]
    post = {"w": _normal(generator, device, 1, c, 3, 3), "b": torch.zeros(1, device=device)}
    return {"convs": convs, "post": post}


def _stft_mag(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[B, T] -> |STFT| [B, n_fft // 2 + 1, frames]: the (n_fft - hop) / 2
    reflect pre-pad, frames of n_fft samples every hop without a window
    (rectangular, as the reference's torch.stft call without one), sqrt(re^2
    + im^2 + 1e-12)."""
    pad = int((n_fft - hop) / 2)
    wav = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    spec = torch.fft.rfft(wav.unfold(-1, n_fft, hop), n=n_fft, dim=-1)
    return torch.sqrt(spec.real**2 + spec.imag**2 + 1e-12).transpose(-1, -2)


def resolution_discriminator(dr: Params, wav: torch.Tensor, resolution: Sequence[int]):
    """wav [B, 1, T] at resolution (n_fft, hop, win) -> (score [B, N],
    feature maps [B, C, F, frames]); convs over the magnitude with leaky
    ReLU 0.1 (win does not enter: the window is rectangular)."""
    n_fft, hop, _ = resolution
    x = _stft_mag(wav[:, 0], n_fft, hop)[:, None]
    fmap = []
    for c, st in zip(dr["convs"], MRD_STRIDES):
        kh, kw = c["w"].shape[2:]
        x = _leaky_relu(CV.conv(x, c["w"], c["b"], stride=st, padding=(kh // 2, kw // 2)))
        fmap.append(x)
    x = CV.conv(x, dr["post"]["w"], dr["post"]["b"], padding=(1, 1))
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def init_mrd(generator: torch.Generator, n: int = 3, d_mult: int = 1, device="cpu") -> list:
    return [init_resolution_discriminator(generator, d_mult, device) for _ in range(n)]


def discriminate(mpd: list, mrd: list, resolutions, real: torch.Tensor, fake: torch.Tensor,
                 periods: Sequence[int] = DEFAULT_PERIODS):
    """Every discriminator on (real, fake) -> (real scores, fake scores, real
    feature maps, fake feature maps), MPD's then MRD's."""
    y_r, y_g, f_r, f_g = [], [], [], []
    runs = [(lambda w, dp=dp, p=p: period_discriminator(dp, w, p)) for dp, p in zip(mpd, periods)]
    runs += [(lambda w, dr=dr, r=r: resolution_discriminator(dr, w, r))
             for dr, r in zip(mrd, resolutions)]
    for run in runs:
        sr, fr = run(real)
        sg, fg = run(fake)
        y_r.append(sr)
        y_g.append(sg)
        f_r.append(fr)
        f_g.append(fg)
    return y_r, y_g, f_r, f_g


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 x the sum over discriminators and layers of mean |real - fake|."""
    return 2.0 * sum(torch.mean(torch.abs(r - g)) for dr, dg in zip(fmap_r, fmap_g)
                     for r, g in zip(dr, dg))


def discriminator_loss(real_outs, gen_outs):
    """LSGAN: sum of mean (1 - real)^2 + mean fake^2 -> (loss, real terms,
    fake terms)."""
    r_losses = [torch.mean((1.0 - dr) ** 2) for dr in real_outs]
    g_losses = [torch.mean(dg**2) for dg in gen_outs]
    return sum(r + g for r, g in zip(r_losses, g_losses)), r_losses, g_losses


def generator_loss(disc_outs):
    """LSGAN: sum of mean (1 - fake)^2 -> (loss, terms)."""
    losses = [torch.mean((1.0 - dg) ** 2) for dg in disc_outs]
    return sum(losses), losses
