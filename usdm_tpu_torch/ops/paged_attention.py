"""K1: paged-KV decode attention (kernel in csrc/paged_attention.cu).

Port of usdm_tpu/ops/paged_attention.py.  Layout as in the JAX engine:
q [B, Hkv, G, d] (query heads grouped by kv head), page pools
[Hkv, NT, P, d] (NT = layers * pages: the caller offsets the page table by
the layer's region), page_table [B, maxp] int32, seq_lens [B] int32 valid kv
count including the current token.

int8 pools (the engine's kv_dtype="int8") come with f32 per-(head, token)
scale pools k_scales / v_scales [NT, Hkv, P], page-major as in the JAX
engine.  The plain version dequantizes after the gather and rounds K/V to
q's dtype, as the JAX reference does; the kernel folds the scales into the
softmax in f32 (k-scales on the scores, v-scales on the probabilities), as
the Pallas kernel does.

`paged_decode_attention` launches the CUDA kernel for CUDA tensors and runs
`paged_decode_attention_reference` for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from usdm_tpu_torch.ops import _build

NEG_INF = -1e30

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# f32 score and accumulator staging of the kernel's 8 warps, 4 * 8 * G *
# (page + d) bytes: 24 KiB at page 64, 48 KiB at page 256 (G 4, d 128)
MAX_SMEM = 96 * 1024


def paged_decode_attention_reference(
    q: torch.Tensor,  # [B, Hkv, G, d]
    k_pages: torch.Tensor,  # [Hkv, NT, P, d]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, maxp]
    seq_lens: torch.Tensor,  # [B]
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # [NT, Hkv, P] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain gather version with the kernel's semantics (f32 scores and
    softmax; probabilities cast to the value dtype as in the JAX golden).
    int8 pools dequantize after the gather, rounded to q's dtype."""
    b, hkv, g, d = q.shape
    p = k_pages.shape[2]
    scale = d**-0.5 if scale is None else scale
    table = page_table.long()
    kc = k_pages[:, table]  # [Hkv, B, maxp, P, d]
    vc = v_pages[:, table]
    if k_scales is not None:  # page-major scales [NT, Hkv, P] -> [Hkv, B, maxp, P]
        kc = (kc.float() * k_scales[table].permute(2, 0, 1, 3)[..., None]).to(q.dtype)
        vc = (vc.float() * v_scales[table].permute(2, 0, 1, 3)[..., None]).to(q.dtype)
    s_max = kc.shape[2] * p
    kc = kc.transpose(0, 1).reshape(b, hkv, s_max, d)
    vc = vc.transpose(0, 1).reshape(b, hkv, s_max, d)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), kc.float()) * scale
    pos = torch.arange(s_max, device=q.device)[None, None, None, :]
    lens = seq_lens.long()[:, None, None, None]
    valid = pos < lens
    if sliding_window is not None:
        valid = valid & ((lens - 1) - pos <= sliding_window)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", probs.to(vc.dtype).float(), vc.float())
    return out.to(q.dtype)


def paged_decode_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    page_table: torch.Tensor,
    seq_lens: torch.Tensor,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """-> [B, Hkv, G, d].  Every seq_len must be >= 1 and its pages must be in
    the table.  int8 pools take k_scales and v_scales."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages, page_table, seq_lens,
                                                sliding_window, scale, k_scales, v_scales)
    return _launch(q, k_pages, v_pages, page_table, seq_lens, sliding_window, scale,
                   k_scales, v_scales)


paged_decode_attention.launches = 0  # launches over bf16/f32 pools
paged_decode_attention.int8_launches = 0  # launches over int8 pools


def _launch(q, k_pages, v_pages, page_table, seq_lens, sliding_window, scale, k_scales,
            v_scales):
    name = "paged_decode_attention"
    quant = k_scales is not None
    scales = (k_scales, v_scales) if quant else ()
    _build.require_cuda(name, q, k_pages, v_pages, page_table, seq_lens, *scales)
    b, hkv, g, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape[0] != hkv or k_pages.shape[3] != d:
        raise ValueError(f"{name}: pool shape {tuple(k_pages.shape)} does not match "
                         f"q {tuple(q.shape)}")
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: k/v pool shapes differ")
    kv_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in _build.DTYPE_CODES or k_pages.dtype != kv_dtype or v_pages.dtype != kv_dtype:
        raise TypeError(f"{name}: q must be float32 or bfloat16 and the pools {kv_dtype} "
                        f"(int8 with scales), got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    sshape = (k_pages.shape[1], hkv, k_pages.shape[2])
    if quant and any(a.dtype != torch.float32 or a.shape != sshape for a in scales):
        raise ValueError(f"{name}: k_scales/v_scales must be float32 {sshape}")
    if page_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name}: page_table and seq_lens must be int32")
    if page_table.dim() != 2 or page_table.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"{name}: page_table {tuple(page_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match batch {b}")
    if d % 32 or d > 128 or g > 8 or 32 * g * (k_pages.shape[2] + d) > MAX_SMEM:
        raise ValueError(f"{name}: head_dim must be a multiple of 32 up to 128, group "
                         f"size <= 8, and 8 warps x G x (page + d) f32 within "
                         f"{MAX_SMEM // 1024} KiB of shared memory; got d={d} G={g} "
                         f"page={k_pages.shape[2]}")
    for t in (q, k_pages, v_pages, page_table, seq_lens, *scales):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    scale = d**-0.5 if scale is None else scale
    window = -1 if sliding_window is None else int(sliding_window)
    kv_code = _build.INT8_CODE if quant else _build.DTYPE_CODES[q.dtype]
    out = torch.empty_like(q)
    fn = _build.kernel("usdm_paged_decode", _ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), b, hkv, g, d,
             k_pages.shape[1], k_pages.shape[2], page_table.shape[1], window, float(scale),
             _build.DTYPE_CODES[q.dtype], kv_code, _build.stream_ptr(q.device))
    _build.check(err, name)
    if quant:
        paged_decode_attention.int8_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out
