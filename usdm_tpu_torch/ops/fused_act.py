"""K3: BigVGAN's anti-aliased snake activation in one pass
(kernel in csrc/fused_act.cu).

Port of usdm_tpu/ops/fused_act.py: up(2x, 12-tap kaiser sinc) -> snake or
snake-beta (f32, optional log-scale alpha/beta) -> down(2x, 12 taps), with
both resamplers' replicate padding.  The port keeps BigVGAN channels-first:
x [B, C, T], alpha/beta [C].

`fused_activation1d` launches the CUDA kernel for CUDA tensors and runs
`activation1d_reference` (the plain three-op composition) for CPU tensors;
its gradient, on either, is the vjp of that composition recomputed from the
saved inputs (`_FusedActivation1d`, usdm_tpu's custom_vjp).  The launch
count counts forward launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from usdm_tpu_torch.ops import _build
from usdm_tpu_torch.ops import conv as CV

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """[kernel_size] normalized low-pass FIR (sum = 1); same construction as
    usdm_tpu.models.bigvgan.kaiser_sinc_filter1d."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    a = 2.285 * (half_size - 1) * np.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        return np.zeros(kernel_size, np.float32)
    filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
    filt /= filt.sum()
    return filt.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _resample_filter() -> np.ndarray:
    """The 12-tap filter shared by the 2x up- and downsampler."""
    return kaiser_sinc_filter1d(0.25, 0.3, 12)


def _depthwise(filt: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(filt).to(x.device, x.dtype).view(1, 1, -1).expand(x.shape[1], 1, -1)


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x upsample of [B, C, T] (replicate pad 5, zero-stuffed
    12-tap transposed conv with gain 2, crop 15 per side)."""
    f = _resample_filter()
    y = CV.conv(F.pad(x, (5, 5), mode="replicate"), _depthwise(2.0 * f, x), stride=2,
                groups=x.shape[1], transposed=True)
    return y[..., 15:-15]


def downsample2(x: torch.Tensor) -> torch.Tensor:
    """Anti-aliased 2x downsample of [B, C, T] (replicate pad 5/6, strided
    12-tap conv)."""
    return CV.conv(F.pad(x, (5, 6), mode="replicate"), _depthwise(_resample_filter(), x),
                   stride=2, groups=x.shape[1])


def snake(x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor],
          logscale: bool) -> torch.Tensor:
    """x + (1/b) sin^2(a x) per channel of [B, C, T]; b = a for plain snake.
    In f32, or in f64 when x is f64."""
    a = alpha.to(x.dtype)
    b = a if beta is None else beta.to(x.dtype)
    if logscale:
        a, b = torch.exp(a), torch.exp(b)
    a, b = a[None, :, None], b[None, :, None]
    return x + (1.0 / (b + 1e-9)) * torch.sin(x * a) ** 2


# the kernel's sin^2 (csrc/fused_act.cu sin_sq): the argument reduced by pi,
# then sin(r) = r + r z P(z), z = r^2, P's coefficients those of the kernel
INV_PI = float(np.float32(1 / np.pi))
PI_HI = float(np.float32(np.pi))
PI_LO = float(np.float32(np.pi - PI_HI))
SIN_COEFFS = (-0.166666612, 0.00833310094, -0.000198120179, 2.61099331e-06)  # f32 values


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fma(a, b, c): the product exact in f64, the sum rounded in f64
    then to f32 (one rounding but where the f64 sum itself rounds)."""
    return (a.double() * b + c if isinstance(c, float) else a.double() * b + c.double()).float()


def sin_sq_reduced(v: torch.Tensor) -> torch.Tensor:
    """The kernel's sin^2 of f32 `v` in plain PyTorch, step by step: k =
    rint(v / pi) (the kernel's FMA with 1.5 * 2^23 rounds v * f32(1/pi) once,
    half to even), r = v - k pi_hi - k pi_lo as two FMAs, then s = r + r z
    P(z), z = r^2, by Horner's rule in FMAs, and s * s."""
    v64 = v.float().double()
    k = torch.round(v64 * INV_PI)
    r = (v64 - k * PI_HI).float()
    r = _fma32(k, -PI_LO, r)
    z = r * r
    p = _fma32(z, SIN_COEFFS[3], SIN_COEFFS[2])
    for c in SIN_COEFFS[1::-1]:
        p = _fma32(p, z.double(), c)
    s = _fma32(r * z, p.double(), r)
    return s * s


def activation1d_reference(x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor],
                           logscale: bool) -> torch.Tensor:
    """Plain up -> snake -> down composition in f32, or in f64 for an f64 x
    (beta None = snake)."""
    y = downsample2(snake(upsample2(x.to(torch.promote_types(x.dtype, torch.float32))),
                          alpha, beta, logscale))
    return y.to(x.dtype)


# The kernel's tiling (csrc/fused_act.cu kR, kLanes): a warp takes a task of
# TILE outputs of one row; lane l holds the R samples from tile start - R +
# l R, and lanes 1..LANES-2 write them.
R, LANES = 8, 32
TILE = (LANES - 2) * R


def vector_bytes(x: torch.Tensor, y: torch.Tensor) -> int:
    """The widest vector (16, 8, 4 or, for bf16, 2 bytes) that x, y and every
    row start of the [B, C, T] tensors are aligned to."""
    esize, row = x.element_size(), x.shape[-1] * x.element_size()
    for v in (16, 8, 4, 2):
        if v >= esize and x.data_ptr() % v == 0 and y.data_ptr() % v == 0 and row % v == 0:
            return v
    return esize


BACKWARD_SPAN = "fused_activation1d.backward"  # the recompute's span in a profiler trace


class _FusedActivation1d(torch.autograd.Function):
    """usdm_tpu's custom_vjp (usdm_tpu/ops/fused_act.py:164-195): the
    forward is K3 on a CUDA tensor (the plain version on a CPU tensor); it
    saves (x, alpha, beta), and the backward is the vjp of the plain
    composition recomputed from them, as usdm_tpu's _vjp_bwd takes it (no
    backward kernel: usdm_tpu has none)."""

    @staticmethod
    def forward(ctx, x, alpha, beta, logscale):
        ctx.save_for_backward(x, alpha, beta)
        ctx.logscale = logscale
        if x.device.type == "cpu":
            return activation1d_reference(x, alpha, beta, logscale)
        return _launch(x, alpha, beta, logscale)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad(), torch.profiler.record_function(BACKWARD_SPAN):
            x, alpha, beta = (None if t is None else t.detach().requires_grad_(need)
                              for t, need in zip(saved, ctx.needs_input_grad))
            y = activation1d_reference(x, alpha, beta, ctx.logscale)
            wrt = [t for t in (x, alpha, beta) if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in (x, alpha, beta)), None)


def fused_activation1d(x: torch.Tensor, alpha: torch.Tensor, beta: Optional[torch.Tensor],
                       logscale: bool) -> torch.Tensor:
    """[B, C, T] -> [B, C, T]: BigVGAN Activation1d (snake-beta when `beta`
    is given, snake otherwise), differentiable in x, alpha and beta."""
    return _FusedActivation1d.apply(x, alpha, beta, logscale)


fused_activation1d.launches = 0


def _f32(v: torch.Tensor) -> torch.Tensor:
    return v if v.dtype == torch.float32 and v.is_contiguous() else v.float().contiguous()


def _launch(x, alpha, beta, logscale):
    """One launch of the kernel.  Reads nothing back from the device, so a
    call captures in a CUDA graph."""
    name = "fused_activation1d"
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be [B, C, T], got {tuple(x.shape)}")
    bsz, c, t = x.shape
    if x.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if not 1 <= t <= 2**29 or bsz * c * -(-t // TILE) > 2**30:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")
    a = _f32(alpha)
    b = a if beta is None else _f32(beta)
    if a.shape != (c,) or b.shape != (c,):
        raise ValueError(f"{name}: alpha/beta must be [{c}]")
    dev = x.device
    if not (x.is_cuda and a.device == dev and b.device == dev):
        _build.require_cuda(name, x, a, b)  # raises, naming the devices
    y = torch.empty_like(x)
    fn = _build.kernel("usdm_fused_snake", _ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(), bsz, c, t, int(logscale),
             _build.DTYPE_CODES[x.dtype], vector_bytes(x, y), _build.stream_ptr(dev))
    _build.check(err, name)
    fused_activation1d.launches += 1
    return y
