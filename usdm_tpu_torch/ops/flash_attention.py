"""K2 and K5: flash attention forward and backward (kernels in
csrc/flash_attention.cu and csrc/flash_attention_bwd.cu).

Port of usdm_tpu/ops/flash_attention.py.  Same interface as the JAX wrapper:
q [B, Tq, H, d], k/v [B, Tk, Hkv, d], segment ids and positions [B, T] int;
masks come from segments (negative = padding) and positions (causal, sliding
window), optional Voicebox ALiBi.  Fully-masked query rows output 0 and get
zero gradient.

`flash_attention` is a `torch.autograd.Function` like the JAX custom_vjp: its
forward saves q, k, v, o, the log-sum-exp, positions and segments, and its
backward recomputes the probabilities from the log-sum-exp.  For CUDA
tensors the forward launches K2 and the backward the two K5 kernels (dq, and
dk/dv summed over the GQA group); for CPU tensors both run their plain
versions below.

The kernels take ragged Tq/Tk and strided operands as they are (no padding,
no transposes).  They derive their tile skips from positions, so query and
key positions need not be aligned by flat index (chunked prefill), where the
Pallas kernels' flat-index skip and clamp drop keys.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from usdm_tpu_torch.ops import _build

NEG_INF = -1e30
BWD_BLOCK_K = 512  # keys per block of the plain backward: O(T * 512) memory

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 12
             + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def alibi_slopes_pow2(n_heads: int) -> torch.Tensor:
    """2^{-(h+1)*8/H}: the kernel's in-kernel ALiBi slopes (equal to the
    xformers table for power-of-2 head counts)."""
    return torch.exp2(-(torch.arange(n_heads, dtype=torch.float32) + 1.0) * (8.0 / n_heads))


def flash_attention_reference(
    q: torch.Tensor,  # [B, Tq, H, d]
    k: torch.Tensor,  # [B, Tk, Hkv, d]
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    alibi: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version with the kernel's semantics -> (o [B, Tq, H, d],
    lse [B, H, Tq] f32).  f32 math throughout."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d**-0.5 if scale is None else scale
    qg = q.float().reshape(b, tq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    qp = q_positions.long()[:, None, None, :, None]
    kp = kv_positions.long()[:, None, None, None, :]
    qs = q_segment_ids.long()[:, None, None, :, None]
    ks = kv_segment_ids.long()[:, None, None, None, :]
    mask = (qs == ks) & (qs >= 0)
    if causal:
        mask = mask & (qp >= kp)
    if sliding_window is not None:
        mask = mask & (qp - kp <= sliding_window)
    if alibi:
        slope = alibi_slopes_pow2(h).to(q.device).reshape(1, hkv, g, 1, 1)
        s = s - slope * (qp - kp).abs().float() * (kp != 0).float()
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / torch.where(l > 0, l, 1.0), v.float())
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0].reshape(b, h, tq)
    return o.reshape(b, tq, h, d).to(q.dtype), lse


def flash_attention_bwd_reference(
    q: torch.Tensor,  # [B, Tq, H, d]
    k: torch.Tensor,  # [B, Tk, Hkv, d]
    v: torch.Tensor,
    o: torch.Tensor,  # [B, Tq, H, d], the forward's output
    lse: torch.Tensor,  # [B, H, Tq] f32, the forward's log-sum-exp
    do: torch.Tensor,  # [B, Tq, H, d], the output's gradient
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    alibi: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward with the kernels' semantics -> (dq, dk, dv) in the
    layouts and dtypes of q, k, v.  Port of usdm_tpu's `_bwd_reference`:
    recompute P = exp(S - lse) per block of BWD_BLOCK_K keys,
    dS = P * (dP - rowsum(dO * O)) * scale, f32 math throughout."""
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d**-0.5 if scale is None else scale
    qf = q.float().reshape(b, tq, hkv, g, d)
    go = do.float().reshape(b, tq, hkv, g, d)
    delta = (go * o.float().reshape(b, tq, hkv, g, d)).sum(-1).permute(0, 2, 3, 1)
    lse_g = lse.float().reshape(b, hkv, g, tq)[..., None]
    qp = q_positions.long()[:, None, None, :, None]
    qs = q_segment_ids.long()[:, None, None, :, None]
    slope = alibi_slopes_pow2(h).to(q.device).reshape(1, hkv, g, 1, 1)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for k0 in range(0, tk, BWD_BLOCK_K):
        blk = slice(k0, k0 + BWD_BLOCK_K)
        ks, vs = k[:, blk].float(), v[:, blk].float()
        kp = kv_positions[:, blk].long()[:, None, None, None, :]
        ksg = kv_segment_ids[:, blk].long()[:, None, None, None, :]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, ks) * scale
        if alibi:
            s = s - slope * (qp - kp).abs().float() * (kp != 0).float()
        mask = (qs == ksg) & (qs >= 0)
        if causal:
            mask = mask & (qp >= kp)
        if sliding_window is not None:
            mask = mask & (qp - kp <= sliding_window)
        p = torch.where(mask, torch.exp(s - lse_g), 0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", go, vs)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, ks)
        dks.append(torch.einsum("bhgqk,bqhgd->bkhd", ds, qf))
        dvs.append(torch.einsum("bhgqk,bqhgd->bkhd", p, go))
    return (dq.reshape(b, tq, h, d).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


class _Flash(torch.autograd.Function):
    """The counterpart of usdm_tpu's `_flash` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, window, scale, alibi):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal,
                                               window, scale, alibi)
        else:
            o, lse = _launch(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, window, scale,
                             alibi)
        ctx.save_for_backward(q, k, v, o, lse, q_seg, kv_seg, q_pos, kv_pos)
        ctx.attrs = (causal, window, scale, alibi)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        saved = ctx.saved_tensors  # read once: remat allows one unpack
        dq, dk, dv = flash_attention_bwd(*saved[:5], do, *saved[5:], *ctx.attrs)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    alibi: bool = False,
    return_lse: bool = False,
):
    """-> o [B, Tq, H, d] (and lse [B, H, Tq] f32 with return_lse);
    differentiable in q, k and v."""
    h, hkv = q.shape[2], k.shape[2]
    if h % hkv:
        raise ValueError(f"flash_attention: {h} heads do not group over {hkv} kv heads")
    if alibi and h & (h - 1):
        raise ValueError("flash_attention: in-kernel ALiBi needs a power-of-2 head count")
    scale = q.shape[3]**-0.5 if scale is None else scale
    o, lse = _Flash.apply(q, k, v, q_segment_ids, kv_segment_ids, q_positions, kv_positions,
                          causal, sliding_window, scale, alibi)
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, q_segment_ids, kv_segment_ids, q_positions,
                        kv_positions, causal=True, sliding_window=None, scale=None,
                        alibi=False):
    """(dq, dk, dv) of `flash_attention`: the two K5 kernels for CUDA
    tensors (delta = rowsum(dO * O) is a torch op, as in usdm_tpu), the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, q_segment_ids,
                                             kv_segment_ids, q_positions, kv_positions,
                                             causal, sliding_window, scale, alibi)
    if do.stride(-1) != 1:
        do = do.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()  # [B, H, Tq]
    args = (q, k, v, do, lse, delta, q_segment_ids, kv_segment_ids, q_positions,
            kv_positions, causal, sliding_window, scale, alibi)
    dq = flash_attention_bwd_dq(*args)
    dk, dv = flash_attention_bwd_dkv(*args)
    return dq, dk, dv


def _int32_rows(name: str, x: torch.Tensor, b: int, t: int) -> torch.Tensor:
    if x.shape != (b, t):
        raise ValueError(f"flash_attention: {name} must be [{b}, {t}], got {tuple(x.shape)}")
    return x.to(torch.int32).contiguous()


def _check_qkv(name, q, k, v, *extra):
    """Shapes, dtypes and strides the kernels take; `extra` are further
    [B, Tq, H, d] operands (dO)."""
    b, tq, h, d = q.shape
    if k.shape[0] != b or v.shape != k.shape or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    for t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{name}: {tuple(t.shape)} does not match q {tuple(q.shape)}")
    if q.dtype not in _build.DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, *extra)):
        raise TypeError(f"{name}: q/k/v{'/dO' if extra else ''} must share dtype float32 or "
                        f"bfloat16, got {[t.dtype for t in (q, k, v, *extra)]}")
    if d % 16 or d > 128:
        raise ValueError(f"{name}: head_dim must be a multiple of 16 up to 128, got {d}")
    for t in (q, k, v, *extra):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous")


def _rows(q_seg, kv_seg, q_pos, kv_pos, b, tq, tk):
    return (_int32_rows("q_segment_ids", q_seg, b, tq),
            _int32_rows("kv_segment_ids", kv_seg, b, tk),
            _int32_rows("q_positions", q_pos, b, tq),
            _int32_rows("kv_positions", kv_pos, b, tk))


def _launch(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, window, scale, alibi):
    name = "flash_attention"
    _build.require_cuda(name, q, k, v, q_seg, kv_seg, q_pos, kv_pos)
    _check_qkv(name, q, k, v)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    q_seg, kv_seg, q_pos, kv_pos = _rows(q_seg, kv_seg, q_pos, kv_pos, b, tq, tk)
    scale = d**-0.5 if scale is None else scale
    o = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    fn = _build.kernel("usdm_flash_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             q_pos.data_ptr(), kv_pos.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(),
             b, h, hkv, tq, tk, d,
             q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2), o.stride(0), o.stride(1), o.stride(2),
             int(causal), -1 if window is None else int(window), int(alibi), float(scale),
             _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, name)
    flash_attention.launches += 1
    return o, lse


_STRIDES = ctypes.POINTER(ctypes.c_longlong)  # (b, t, h) strides of each operand
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [_STRIDES]
                 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [_STRIDES]
                 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _bwd_operands(name, q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos):
    """Checks shared by the two K5 launchers -> int32 rows."""
    _build.require_cuda(name, q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos)
    _check_qkv(name, q, k, v, do)
    b, tq, h, _ = q.shape
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.shape != (b, h, tq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous f32 [{b}, {h}, {tq}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return _rows(q_seg, kv_seg, q_pos, kv_pos, b, tq, k.shape[1])


def _strides(*tensors):
    flat = [s for t in tensors for s in (t.stride(0), t.stride(1), t.stride(2))]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos,
                           causal=True, sliding_window=None, scale=None, alibi=False):
    """K5 dq kernel (CUDA only): dq [B, Tq, H, d] in q's dtype."""
    name = "flash_attention_bwd_dq"
    q_seg, kv_seg, q_pos, kv_pos = _bwd_operands(name, q, k, v, do, lse, delta, q_seg, kv_seg,
                                                 q_pos, kv_pos)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    fn = _build.kernel("usdm_flash_bwd_dq", _BWD_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dq.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
             q_seg.data_ptr(), kv_seg.data_ptr(), b, h, hkv, tq, tk, d,
             _strides(q, k, v, do, dq), int(causal),
             -1 if sliding_window is None else int(sliding_window), int(alibi),
             float(d**-0.5 if scale is None else scale), _build.DTYPE_CODES[q.dtype],
             _build.stream_ptr(q.device))
    _build.check(err, name)
    flash_attention_bwd_dq.launches += 1
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos,
                            causal=True, sliding_window=None, scale=None, alibi=False):
    """K5 dk/dv kernel (CUDA only): (dk, dv) [B, Tk, Hkv, d] in k's dtype,
    summed over each kv head's query group."""
    name = "flash_attention_bwd_dkv"
    q_seg, kv_seg, q_pos, kv_pos = _bwd_operands(name, q, k, v, do, lse, delta, q_seg, kv_seg,
                                                 q_pos, kv_pos)
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    dk = torch.empty((b, tk, hkv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    fn = _build.kernel("usdm_flash_bwd_dkv", _DKV_ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
             delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), q_pos.data_ptr(),
             kv_pos.data_ptr(), q_seg.data_ptr(), kv_seg.data_ptr(), b, h, hkv, tq, tk, d,
             _strides(q, k, v, do, dk, dv), int(causal),
             -1 if sliding_window is None else int(sliding_window), int(alibi),
             float(d**-0.5 if scale is None else scale), _build.DTYPE_CODES[q.dtype],
             _build.stream_ptr(q.device))
    _build.check(err, name)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_bwd_dkv.launches = 0
