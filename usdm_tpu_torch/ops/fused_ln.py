"""K4: fused residual add + row mask + LayerNorm (kernel in csrc/fused_ln.cu).

Port of usdm_tpu/ops/fused_ln.py, the Voicebox estimator's post-LN step:

    out = LN((x + r) * rowmask) * w + b        (optionally * rowmask again)

with f32 statistics, the normalized row rounded to the input dtype before the
scale and shift, and row t of batch b valid iff t < lengths[b] (the mask is
computed from `lengths`, never streamed).  `add_mask_ln` is a
`torch.autograd.Function` like the JAX custom_vjp.  For CUDA tensors its
forward and its backward each launch a kernel (`add_mask_ln_bwd`: one
streaming pass for dx = dr, then a fixed-order sum of the per-block dw / db
partials); for CPU tensors they run the plain versions `add_mask_ln_reference`
and `add_mask_ln_backward_reference`, the vjp of usdm_tpu's `_xla_ref`
written out.  `lengths` gets no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from usdm_tpu_torch.ops import _build

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
BWD_MAX_BLOCKS = 264  # the backward's grid at most: two blocks per SM on 132 SMs


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


def add_mask_ln_backward_reference(x: torch.Tensor, r: torch.Tensor, lengths: torch.Tensor,
                                   w: torch.Tensor, g: torch.Tensor, post_mask: bool = False,
                                   eps: float = 1e-5):
    """Plain version of the backward: the vjp of `add_mask_ln_reference` in
    the direction g [B, T, H], step by step as the kernel computes it ->
    (dx, dr, dw, db); dx and dr are one tensor.  Roundings to x's dtype where
    the forward's tensor ops round: dn = round(gy * w), each row's
    round(gy * n) before dw's sum, the sums of dw and db, and ds."""
    t = x.shape[1]
    m = (torch.arange(t, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)[:, :, None]
    xf = ((x + r) * m).float()
    mu = xf.mean(dim=-1, keepdim=True)
    d = xf - mu
    rstd = torch.rsqrt((d * d).mean(dim=-1, keepdim=True) + eps)
    nf = d * rstd  # the normalized row before its rounding
    gy = g * m if post_mask else g
    db = gy.float().sum(dim=(0, 1)).to(x.dtype)
    dw = (gy * nf.to(x.dtype)).float().sum(dim=(0, 1)).to(x.dtype)
    dn = (gy * w).float()
    dd = rstd * (dn - nf * (dn * nf).mean(dim=-1, keepdim=True))
    ds = (dd - dd.mean(dim=-1, keepdim=True)).to(x.dtype) * m
    return ds, ds, dw, db


class _AddMaskLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, lengths, w, b, post_mask, eps):
        ctx.attrs = (post_mask, eps)
        if x.device.type == "cpu":
            ctx.save_for_backward(x, r, lengths, w, b)
            return add_mask_ln_reference(x, r, lengths, w, b, post_mask, eps)
        # the estimator's first layer gets its input in the positional conv's
        # channel-first layout; the kernels read rows, so the rows are saved
        x, r = x.contiguous(), r.contiguous()
        ctx.save_for_backward(x, r, lengths, w, b)
        return _launch(x, r, lengths, w, b, post_mask, eps)

    @staticmethod
    def backward(ctx, g):
        x, r, lengths, w, _ = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = add_mask_ln_backward_reference(x, r, lengths, w, g, *ctx.attrs)
        else:
            grads = add_mask_ln_bwd(x, r, lengths, w, g.contiguous(), *ctx.attrs)
        dx, dr, dw, db = grads
        return dx, dr, None, dw, db, None, None


def add_mask_ln(x: torch.Tensor, r: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor, post_mask: bool = False, eps: float = 1e-5) -> torch.Tensor:
    """LN((x + r) * rowmask) * w + b (optionally * rowmask) -> [B, T, H] in
    x's dtype; differentiable in x, r, w and b."""
    return _AddMaskLN.apply(x, r, lengths, w, b, post_mask, eps)


add_mask_ln.launches = 0


def _check(name, x, r, lengths, w, b):
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


def _launch(x, r, lengths, w, b, post_mask, eps):
    name = "add_mask_ln"
    _check(name, x, r, lengths, w, b)
    bsz, t, h = x.shape
    lengths = lengths.to(torch.int32).contiguous()  # a no-op for the estimator's int32 lengths
    out = torch.empty_like(x)
    fn = _build.kernel("usdm_add_mask_ln", _ARGTYPES)
    err = fn(x.data_ptr(), r.data_ptr(), lengths.data_ptr(), w.data_ptr(), b.data_ptr(),
             out.data_ptr(), bsz, t, h, int(post_mask), float(eps),
             _build.DTYPE_CODES[x.dtype], _build.stream_ptr(x.device))
    _build.check(err, name)
    add_mask_ln.launches += 1
    return out


def add_mask_ln_bwd(x: torch.Tensor, r: torch.Tensor, lengths: torch.Tensor, w: torch.Tensor,
                    g: torch.Tensor, post_mask: bool = False, eps: float = 1e-5):
    """The backward kernel on CUDA tensors: (dx, dr, dw, db) of
    `add_mask_ln_backward_reference`, dx and dr one tensor.  Raises on CPU
    tensors (the Function's CPU route runs the plain version)."""
    name = "add_mask_ln_bwd"
    _check(name, x, r, lengths, w, w)
    _build.require_cuda(name, x, g)
    if (g.shape != x.shape or g.dtype != x.dtype or not g.is_contiguous()
            or g.data_ptr() % 16):
        raise ValueError(f"{name}: g {tuple(g.shape)} {g.dtype} must match x {tuple(x.shape)} "
                         f"{x.dtype}, contiguous and 16-byte aligned")
    bsz, t, h = x.shape
    lengths = lengths.to(torch.int32).contiguous()
    n_blocks = min(BWD_MAX_BLOCKS, bsz * t)  # blocks past the last row add zeros
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(w), torch.empty_like(w)
    part = torch.empty((n_blocks, 2, h), dtype=torch.float32, device=x.device)
    fn = _build.kernel("usdm_add_mask_ln_bwd", _BWD_ARGTYPES)
    err = fn(x.data_ptr(), r.data_ptr(), g.data_ptr(), lengths.data_ptr(), w.data_ptr(),
             dx.data_ptr(), dw.data_ptr(), db.data_ptr(), part.data_ptr(), bsz, t, h,
             int(post_mask), float(eps), n_blocks, _build.DTYPE_CODES[x.dtype],
             _build.stream_ptr(x.device))
    _build.check(err, name)
    add_mask_ln_bwd.launches += 1
    return dx, dx, dw, db


add_mask_ln_bwd.launches = 0
