"""Every convolution of the port, f32 ones at full f32 precision on the card.

PyTorch sends an f32 convolution of CUDA tensors to cuDNN, which computes it
in TF32 (a 10-bit mantissa) while `torch.backends.cudnn.allow_tf32` is True,
PyTorch's default.  usdm_tpu computes its convolutions at
Precision.HIGHEST (usdm_tpu/models/bigvgan.py:30), and a TF32 XLS-R feature
can move a unit across a k-means boundary.  So the port's convolutions
(XLS-R's feature extractor and positional conv, Voicebox's conv-pos,
BigVGAN's generator and discriminators, K3's plain version) all go through
`conv` here: on f32 CUDA tensors it runs the forward and its backward
(aten.convolution_backward, in a torch.autograd.Function) with cuDNN's TF32
turned off for the call and restored after it, whatever the process's flag
says.  A lock keeps two threads from restoring the flag under each other.
bf16 convolutions and CPU tensors go straight to aten.convolution, as
F.conv1d / F.conv2d / F.conv_transpose1d do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Union

import torch

_FLAG_LOCK = threading.Lock()

Ints = Union[int, Sequence[int]]


@contextlib.contextmanager
def no_tf32():
    """cuDNN's TF32 off for the enclosed launches, the previous value restored."""
    with _FLAG_LOCK:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


class _FullF32Conv(torch.autograd.Function):
    """aten.convolution and its backward, each under no_tf32."""

    @staticmethod
    def forward(ctx, x, w, b, args):
        ctx.save_for_backward(x, w)
        ctx.args = args
        ctx.bias_sizes = None if b is None else list(b.shape)
        with no_tf32():
            return torch.ops.aten.convolution(x, w, b, *args)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad
        mask = [need[0], need[1], need[2] and ctx.bias_sizes is not None]
        with no_tf32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, w, ctx.bias_sizes, *ctx.args, mask)
        return dx, dw, db, None


def _n(v: Ints, n: int) -> list:
    return [v] * n if isinstance(v, int) else list(v)


def conv(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None, stride: Ints = 1,
         padding: Ints = 0, dilation: Ints = 1, groups: int = 1,
         transposed: bool = False) -> torch.Tensor:
    """F.conv1d / F.conv2d (x [B, C, *S], w [Cout, Cin/g, *K]) or, with
    `transposed`, F.conv_transpose1d/2d (w [Cin, Cout/g, *K]; no output
    padding), the same arithmetic as those calls, f32 on the card without
    TF32."""
    n = x.dim() - 2
    args = (_n(stride, n), _n(padding, n), _n(dilation, n), transposed, [0] * n, groups)
    if x.is_cuda and x.dtype == torch.float32:
        return _FullF32Conv.apply(x, w, b, args)
    return torch.ops.aten.convolution(x, w, b, *args)
