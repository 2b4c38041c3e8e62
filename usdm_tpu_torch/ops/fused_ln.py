"""K4: fused residual add + row mask + LayerNorm (kernel in csrc/fused_ln.cu).

Port of usdm_tpu/ops/fused_ln.py, the Voicebox estimator's post-LN step:

    out = LN((x + r) * rowmask) * w + b        (optionally * rowmask again)

with f32 statistics, the normalized row rounded to the input dtype before the
scale and shift, and row t of batch b valid iff t < lengths[b] (the mask is
computed from `lengths`, never streamed).  `add_mask_ln` is a
`torch.autograd.Function` like the JAX custom_vjp: its forward launches the
kernel for CUDA tensors and runs the plain version for CPU tensors; its
backward recomputes through the plain version with torch.autograd, as the JAX
backward does through `_xla_ref`.  `lengths` gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from usdm_tpu_torch.ops import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def add_mask_ln_reference(x: torch.Tensor, r: torch.Tensor, lengths: torch.Tensor,
                          w: torch.Tensor, b: torch.Tensor, post_mask: bool = False,
                          eps: float = 1e-5) -> torch.Tensor:
    """Plain version: usdm_tpu's `_xla_ref` (x, r [B, T, H]; lengths [B];
    w, b [H])."""
    t = x.shape[1]
    m = (torch.arange(t, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)[:, :, None]
    s = (x + r) * m
    xf = s.float()
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    var = (d * d).mean(dim=-1, keepdim=True)
    y = (d * torch.rsqrt(var + eps)).to(s.dtype) * w + b
    return y * m if post_mask else y


class _AddMaskLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, lengths, w, b, post_mask, eps):
        ctx.save_for_backward(x, r, lengths, w, b)
        ctx.attrs = (post_mask, eps)
        if x.device.type == "cpu":
            return add_mask_ln_reference(x, r, lengths, w, b, post_mask, eps)
        # the estimator's first layer gets its input in the positional conv's
        # channel-first layout; the kernel reads rows
        return _launch(x.contiguous(), r.contiguous(), lengths, w, b, post_mask, eps)

    @staticmethod
    def backward(ctx, g):
        x, r, lengths, w, b = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, r, w, b)]
            out = add_mask_ln_reference(ins[0], ins[1], lengths, ins[2], ins[3], *ctx.attrs)
            dx, dr, dw, db = torch.autograd.grad(out, ins, g)
        return dx, dr, None, dw, db, None, None


def add_mask_ln(x: torch.Tensor, r: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, post_mask: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """LN((x + r) * rowmask) * w + b (optionally * rowmask) -> [B, T, H] in
    x's dtype; differentiable in x, r, w and b."""
    return _AddMaskLN.apply(x, r, lengths, w, b, post_mask, eps)


add_mask_ln.launches = 0


def _launch(x, r, lengths, w, b, post_mask, eps):
    name = "add_mask_ln"
    _build.require_cuda(name, x, r, lengths, w, b)
    bsz, t, h = x.shape
    if r.shape != x.shape or w.shape != (h,) or b.shape != (h,) or lengths.shape != (bsz,):
        raise ValueError(f"{name}: x {tuple(x.shape)}, r {tuple(r.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, lengths {tuple(lengths.shape)} do not match")
    if x.dtype not in _build.DTYPE_CODES or any(a.dtype != x.dtype for a in (r, w, b)):
        raise TypeError(f"{name}: x/r/w/b must share dtype float32 or bfloat16, got "
                        f"{[a.dtype for a in (x, r, w, b)]}")
    if h % 128 or h > 4096:
        raise ValueError(f"{name}: H must be a multiple of 128 up to 4096, got {h}")
    for a in (x, r, w, b):  # the kernel reads 4 neighbouring values at once
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")
    lengths = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    fn = _build.kernel("usdm_add_mask_ln", _ARGTYPES)
    err = fn(x.data_ptr(), r.data_ptr(), lengths.data_ptr(), w.data_ptr(), b.data_ptr(),
             out.data_ptr(), bsz, t, h, int(post_mask), float(eps),
             _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, name)
    add_mask_ln.launches += 1
    return out
