"""K2 and K5: flash attention forward and backward.

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

The kernels have one route per dtype, chosen inside the C entry points:

- bf16: tensor cores (csrc/flash_attention_mma.cu,
  csrc/flash_attention_bwd_dq_mma.cu, csrc/flash_attention_bwd_dkv_mma.cu,
  built from csrc/mma.cuh).  bf16 operands, f32 accumulation, and the
  probabilities and dS rounded to bf16 before the product that consumes
  them, as the Pallas kernels do; `round_operands=True` makes the plain
  versions round at the same places.  Launches of this route are also
  counted in `.mma_launches`.
- f32: the tensor cores in 3xTF32, forward (csrc/flash_attention.cu) and
  backward (csrc/flash_attention_bwd.cu, both built from csrc/tf32.cuh):
  each f32 operand splits into two TF32 values (`tf32_round`) and a product
  is three TF32 products, within ~2^-22 of the f32 product, as the Pallas
  kernels' Precision.HIGHEST asks; `flash_attention_3xtf32_reference` and
  `flash_attention_bwd_3xtf32_reference` emulate the two.  Launches of this
  route are also counted in `.tf32_launches`.

The tensor-core kernels load operands by 16-byte cp.async, so every row
must start on a 16-byte boundary; a view that does not is copied first.

Both take ragged Tq/Tk and strided operands as they are (no padding, no
transposes).  They derive their tile skips from positions, so query and
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
    round_operands: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version with the kernel's semantics -> (o [B, Tq, H, d],
    lse [B, H, Tq] f32).  f32 math throughout (f64 for f64 operands); with
    `round_operands` (and operands narrower than f32) the probabilities are
    rounded to the operands' dtype before P.V, and the row sum is taken from
    the unrounded ones, as the Pallas kernel and the tensor-core route do."""
    return _forward(q, k, v, q_segment_ids, kv_segment_ids, q_positions, kv_positions, causal,
                    sliding_window, scale, alibi, round_operands, torch.einsum)


def _forward(q, k, v, q_segment_ids, kv_segment_ids, q_positions, kv_positions, causal,
             sliding_window, scale, alibi, round_operands, product):
    """The plain forward, its two products taken by product(eq, a, b); f64
    operands are computed in f64 (the yardstick of the f32 routes' error)."""
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d**-0.5 if scale is None else scale
    qg = q.to(ct).reshape(b, tq, hkv, g, d)
    s = product("bqhgd,bkhd->bhgqk", qg, k.to(ct)) * scale
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
        slope = alibi_slopes_pow2(h).to(q.device, ct).reshape(1, hkv, g, 1, 1)
        s = s - slope * (qp - kp).abs().to(ct) * (kp != 0).to(ct)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, 1.0)
    if round_operands and v.dtype != torch.float32:
        o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
        o = o / safe_l[..., 0].permute(0, 3, 1, 2)[..., None]
    elif product is not torch.einsum:  # P split unnormalized, as the kernel splits it
        o = product("bhgqk,bkhd->bqhgd", p, v.to(ct))
        o = o / safe_l[..., 0].permute(0, 3, 1, 2)[..., None]
    else:
        o = torch.einsum("bhgqk,bkhd->bqhgd", p / safe_l, v.to(ct))
    lse = (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0].reshape(b, h, tq)
    return o.reshape(b, tq, h, d).to(q.dtype), lse


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest value with 10 mantissa bits, ties away from zero:
    what `cvt.rna.tf32.f32` gives (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    sign = bits & torch.iinfo(torch.int32).min
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """einsum(eq, a, b) as the tensor cores compute it from TF32 operands:
    terms 3 is 3xTF32 (small.big + big.small + big.big, each operand split as
    big = tf32(x), small = tf32(x - big)), terms 1 one TF32 product."""
    ab, bb = tf32_round(a), tf32_round(b)
    out = torch.einsum(eq, ab, bb)
    if terms == 3:
        out = (torch.einsum(eq, tf32_round(a - ab), bb) + torch.einsum(eq, ab, tf32_round(b - bb))
               + out)
    return out


def flash_attention_3xtf32_reference(
    q: torch.Tensor,  # [B, Tq, H, d] f32
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
    terms: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 route's arithmetic in plain PyTorch, for the tests (no path
    calls it): `flash_attention_reference` with S = Q.K^T and O = P.V taken
    from TF32 operands, `terms` 3 as the kernel does (3xTF32), 1 as a single
    TF32 product would; P is split after the softmax, the row sum taken in
    f32 from the unsplit P."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    return _forward(q, k, v, q_segment_ids, kv_segment_ids, q_positions, kv_positions, causal,
                    sliding_window, scale, alibi, False,
                    lambda eq, a, b: _tf32_product(eq, a, b, terms))


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
    round_operands: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward with the kernels' semantics -> (dq, dk, dv) in the
    layouts and dtypes of q, k, v.  Port of usdm_tpu's `_bwd_reference`:
    recompute P = exp(S - lse) per block of BWD_BLOCK_K keys,
    dS = P * (dP - rowsum(dO * O)) * scale, f32 math throughout (f64 for f64
    operands); with `round_operands` (and operands narrower than f32) P is
    rounded to the operands' dtype before P^T.dO and dS before dS.K and
    dS^T.Q, as the Pallas kernels and the tensor-core route do (dS itself is
    made from the unrounded P)."""
    return _backward(q, k, v, o, lse, do, q_segment_ids, kv_segment_ids, q_positions,
                     kv_positions, causal, sliding_window, scale, alibi, round_operands,
                     torch.einsum)


def _backward(q, k, v, o, lse, do, q_segment_ids, kv_segment_ids, q_positions, kv_positions,
              causal, sliding_window, scale, alibi, round_operands, product):
    """The plain backward, its five products (S, dP, dQ, dK, dV) taken by
    product(eq, a, b)."""
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    b, tq, h, d = q.shape
    tk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = d**-0.5 if scale is None else scale
    qf = q.to(ct).reshape(b, tq, hkv, g, d)
    go = do.to(ct).reshape(b, tq, hkv, g, d)
    delta = (go * o.to(ct).reshape(b, tq, hkv, g, d)).sum(-1).permute(0, 2, 3, 1)
    lse_g = lse.to(ct).reshape(b, hkv, g, tq)[..., None]
    qp = q_positions.long()[:, None, None, :, None]
    qs = q_segment_ids.long()[:, None, None, :, None]
    slope = alibi_slopes_pow2(h).to(q.device, ct).reshape(1, hkv, g, 1, 1)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for k0 in range(0, tk, BWD_BLOCK_K):
        blk = slice(k0, k0 + BWD_BLOCK_K)
        ks, vs = k[:, blk].to(ct), v[:, blk].to(ct)
        kp = kv_positions[:, blk].long()[:, None, None, None, :]
        ksg = kv_segment_ids[:, blk].long()[:, None, None, None, :]
        s = product("bqhgd,bkhd->bhgqk", qf, ks) * scale
        if alibi:
            s = s - slope * (qp - kp).abs().to(ct) * (kp != 0).to(ct)
        mask = (qs == ksg) & (qs >= 0)
        if causal:
            mask = mask & (qp >= kp)
        if sliding_window is not None:
            mask = mask & (qp - kp <= sliding_window)
        p = torch.where(mask, torch.exp(s - lse_g), 0.0)
        dp = product("bqhgd,bkhd->bhgqk", go, vs)
        ds = p * (dp - delta[..., None]) * scale
        if round_operands and q.dtype != torch.float32:
            p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
        dq += product("bhgqk,bkhd->bqhgd", ds, ks)
        dks.append(product("bhgqk,bqhgd->bkhd", ds, qf))
        dvs.append(product("bhgqk,bqhgd->bkhd", p, go))
    return (dq.reshape(b, tq, h, d).to(q.dtype), torch.cat(dks, 1).to(k.dtype),
            torch.cat(dvs, 1).to(v.dtype))


def flash_attention_bwd_3xtf32_reference(
    q: torch.Tensor,  # [B, Tq, H, d] f32
    k: torch.Tensor,  # [B, Tk, Hkv, d]
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    causal: bool = True,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    alibi: bool = False,
    terms: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The f32 backward route's arithmetic in plain PyTorch, for the tests
    (no path calls it): `flash_attention_bwd_reference` with its five
    products taken from TF32 operands, `terms` 3 as the kernels do (3xTF32),
    1 as a single TF32 product would; P and dS are split after they are
    formed in f32, where the kernels split them."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    return _backward(q, k, v, o, lse, do, q_segment_ids, kv_segment_ids, q_positions,
                     kv_positions, causal, sliding_window, scale, alibi, False,
                     lambda eq, a, b: _tf32_product(eq, a, b, terms))


class _Flash(torch.autograd.Function):
    """The counterpart of usdm_tpu's `_flash` custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, window, scale, alibi):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal,
                                               window, scale, alibi,
                                               round_operands=q.dtype != torch.float32)
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
flash_attention.mma_launches = 0  # those of the bf16 tensor-core route
flash_attention.tf32_launches = 0  # those of the f32 route (3xTF32 on the tensor cores)


def flash_attention_bwd(q, k, v, o, lse, do, q_segment_ids, kv_segment_ids, q_positions,
                        kv_positions, causal=True, sliding_window=None, scale=None,
                        alibi=False):
    """(dq, dk, dv) of `flash_attention`: the two K5 kernels for CUDA
    tensors (delta = rowsum(dO * O) is a torch op, as in usdm_tpu), the plain
    version for CPU tensors, which rounds where the card's route of that
    dtype rounds."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, o, lse, do, q_segment_ids,
                                             kv_segment_ids, q_positions, kv_positions,
                                             causal, sliding_window, scale, alibi,
                                             round_operands=q.dtype != torch.float32)
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
    if d % 8 or d > 128:
        raise ValueError(f"{name}: head_dim must be a multiple of 8 up to 128, got {d}")
    for t in (q, k, v, *extra):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the head_dim axis must be contiguous")


def _row_aligned(t: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernels load rows by 16-byte cp.async: the data pointer
    and the batch, time and head strides must be multiples of 16 bytes (8
    bf16 or 4 f32 elements).  A view that is not gets copied into a fresh
    contiguous tensor; it is never sent down another route."""
    st, shape, e = t.stride(), t.shape, 16 // t.element_size()  # this runs for every launch
    if (t.data_ptr() % 16 or (st[0] % e and shape[0] > 1) or (st[1] % e and shape[1] > 1)
            or (st[2] % e and shape[2] > 1)):
        return t.clone(memory_format=torch.contiguous_format)
    return t


def _count(fn, dtype) -> None:
    fn.launches += 1
    if dtype == torch.bfloat16:
        fn.mma_launches += 1
    else:
        fn.tf32_launches += 1


def _rows(q_seg, kv_seg, q_pos, kv_pos, b, tq, tk):
    return (_int32_rows("q_segment_ids", q_seg, b, tq),
            _int32_rows("kv_segment_ids", kv_seg, b, tk),
            _int32_rows("q_positions", q_pos, b, tq),
            _int32_rows("kv_positions", kv_pos, b, tk))


def _launch(q, k, v, q_seg, kv_seg, q_pos, kv_pos, causal, window, scale, alibi):
    name = "flash_attention"
    _build.require_cuda(name, q, k, v, q_seg, kv_seg, q_pos, kv_pos)
    _check_qkv(name, q, k, v)
    q, k, v = _row_aligned(q), _row_aligned(k), _row_aligned(v)
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
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
             int(causal), -1 if window is None else int(window), int(alibi), float(scale),
             _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, name)
    _count(flash_attention, q.dtype)
    return o, lse


_STRIDES = ctypes.POINTER(ctypes.c_longlong)  # (b, t, h) strides of each operand
_BWD_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [_STRIDES]
                 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_DKV_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [_STRIDES]
                 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _bwd_operands(name, q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos):
    """Checks shared by the two K5 launchers -> (q, k, v, do) with rows the
    route of their dtype can load, and the int32 rows."""
    _build.require_cuda(name, q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos)
    _check_qkv(name, q, k, v, do)
    q, k, v, do = (_row_aligned(t) for t in (q, k, v, do))
    b, tq, h, _ = q.shape
    for t, what in ((lse, "lse"), (delta, "delta")):
        if t.shape != (b, h, tq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous f32 [{b}, {h}, {tq}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    return (q, k, v, do), _rows(q_seg, kv_seg, q_pos, kv_pos, b, tq, k.shape[1])


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos,
                           causal=True, sliding_window=None, scale=None, alibi=False):
    """K5 dq kernel (CUDA only): dq [B, Tq, H, d] in q's dtype."""
    name = "flash_attention_bwd_dq"
    (q, k, v, do), (q_seg, kv_seg, q_pos, kv_pos) = _bwd_operands(
        name, q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos)
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
    _count(flash_attention_bwd_dq, q.dtype)
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.mma_launches = 0
flash_attention_bwd_dq.tf32_launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos,
                            causal=True, sliding_window=None, scale=None, alibi=False):
    """K5 dk/dv kernel (CUDA only): (dk, dv) [B, Tk, Hkv, d] in k's dtype,
    summed over each kv head's query group."""
    name = "flash_attention_bwd_dkv"
    (q, k, v, do), (q_seg, kv_seg, q_pos, kv_pos) = _bwd_operands(
        name, q, k, v, do, lse, delta, q_seg, kv_seg, q_pos, kv_pos)
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
    _count(flash_attention_bwd_dkv, q.dtype)
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.mma_launches = 0
flash_attention_bwd_dkv.tf32_launches = 0


def mma_tile_products(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The single-tile harness of csrc/mma_harness.cu (CUDA only): for bf16 [64, d]
    operands -> (S = q.k^T [64, 64], O = bf16(S).v [64, d]), both f32, through
    the kernels' tile loader, ldmatrix addressing and mma fragments.  For
    checking those parts apart from masks and softmax; no path calls it."""
    name = "mma_tile_products"
    _build.require_cuda(name, q, k, v)
    d = q.shape[1]
    for t in (q, k, v):
        if t.shape != (64, d) or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous bf16 [64, d]")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"{name}: d must be a multiple of 16 up to 128, got {d}")
    s_out = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    o_out = torch.empty((64, d), dtype=torch.float32, device=q.device)
    fn = _build.kernel("usdm_mma_tile_products",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), s_out.data_ptr(),
                    o_out.data_ptr(), d, _build.stream_ptr(q.device)), name)
    return s_out, o_out


MIX_MODES = ("mix", "mma", "ldmatrix", "reuse")  # modes 0-3 of csrc/mma_harness.cu
MIX_TILE_BYTES = 3 * 64 * (64 + 8) * 2  # the Q, K and V tiles a block of the probe holds


def mma_mix_rate(mode: str, iters: int, blocks: int, smem: int, device) -> torch.Tensor:
    """Launch the rate probe of csrc/mma_harness.cu (CUDA only): `blocks`
    blocks of 4 warps repeat one 64-key step of the forward kernel's products
    `iters` times on resident d 64 tiles: "mix" as the kernels run them (per
    warp 36 ldmatrix.x4 and 64 mma), "mma" (128 mma) and "ldmatrix" (36) alone,
    "reuse" with each K/V fragment used for two 16-row tiles (36 ldmatrix.x4
    per 128 mma).  `smem` bytes of shared memory per block set how many blocks
    an SM holds.  Returns the sink the blocks write; the caller times it."""
    name = "mma_mix_rate"
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(64, 64, generator=gen, device=dev).bfloat16() * 0.1
               for _ in range(3))
    _build.require_cuda(name, q)
    if mode not in MIX_MODES or smem < MIX_TILE_BYTES:
        raise ValueError(f"{name}: mode {mode!r} or {smem} bytes of shared memory not taken")
    out = torch.empty(blocks * 128, dtype=torch.float32, device=dev)
    fn = _build.kernel("usdm_mma_mix_rate",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), iters,
                    MIX_MODES.index(mode), blocks, smem, _build.stream_ptr(dev)), name)
    return out
