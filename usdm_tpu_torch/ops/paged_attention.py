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
`paged_decode_attention_reference` for CPU tensors.  The kernel splits each
slot's valid rows over `n_splits` blocks (chosen from shapes alone by
`split_count`, or given by a test) and merges their partial softmax states
in a second launch; `paged_decode_attention_split_reference` is that
computation in plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from usdm_tpu_torch.ops import _build

NEG_INF = -1e30

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
ROW_ALIGN = 16  # a split's row count is a multiple of this (csrc: kRowAlign)
MAX_SPLITS = 1024
# blocks the host's choice of n_splits aims at: two per SM
BLOCKS_PER_SM = 2
# the host's choice never cuts a slot finer than this many splits
MAX_AUTO_SPLITS = 32


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


def split_rows(seq_lens: torch.Tensor, sliding_window: Optional[int], n_splits: int):
    """The kernel's cut of each slot's valid rows [lo, kv_len) into n_splits
    contiguous ranges of ceil((kv_len - lo) / n_splits) rows rounded up to
    ROW_ALIGN -> (r0, r1) [B, n_splits] int64; a split past the valid rows
    is empty (r0 == r1 == kv_len)."""
    lens = seq_lens.long()
    lo = torch.zeros_like(lens) if sliding_window is None else (
        lens - 1 - sliding_window).clamp(min=0)
    chunk = (lens - lo + n_splits - 1) // n_splits
    chunk = (chunk + ROW_ALIGN - 1) // ROW_ALIGN * ROW_ALIGN
    s = torch.arange(n_splits, device=lens.device)
    r0 = torch.minimum(lo[:, None] + s[None] * chunk[:, None], lens[:, None])
    r1 = torch.minimum(r0 + chunk[:, None], lens[:, None])
    return r0, r1


def paged_decode_attention_split_reference(
    q: torch.Tensor,  # [B, Hkv, G, d]
    k_pages: torch.Tensor,  # [Hkv, NT, P, d]
    v_pages: torch.Tensor,
    page_table: torch.Tensor,  # [B, maxp]
    seq_lens: torch.Tensor,  # [B]
    n_splits: int,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,  # [NT, Hkv, P] f32 (int8 pools)
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's computation in plain PyTorch, for the tests (no path
    calls it): each of n_splits row ranges (`split_rows`) gives a partial
    state (m, l, acc) from f32 scores and probabilities, int8 scales folded
    as the kernel folds them (k-scale on the score, v-scale on the
    probability, not in the sum); an empty split gives (-1e30, 0, 0).  Then
    out = sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s."""
    b, hkv, g, d = q.shape
    p = k_pages.shape[2]
    scale = d**-0.5 if scale is None else scale
    table = page_table.long()
    s_max = table.shape[1] * p
    kc = k_pages[:, table].float().transpose(0, 1).reshape(b, hkv, s_max, d)
    vc = v_pages[:, table].float().transpose(0, 1).reshape(b, hkv, s_max, d)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), kc) * scale
    if k_scales is not None:  # [NT, Hkv, P] -> [B, Hkv, 1, s_max]
        ksc, vsc = (a[table].permute(0, 2, 1, 3).reshape(b, hkv, 1, s_max)
                    for a in (k_scales, v_scales))
        scores = scores * ksc
    r0, r1 = split_rows(seq_lens, sliding_window, n_splits)
    pos = torch.arange(s_max, device=q.device)
    ms, ls, accs = [], [], []
    for si in range(n_splits):
        inside = (pos[None] >= r0[:, si:si + 1]) & (pos[None] < r1[:, si:si + 1])  # [B, s]
        inside = inside[:, None, None, :]
        sc = torch.where(inside, scores, NEG_INF)
        m = sc.amax(-1, keepdim=True)  # -1e30 for an empty split
        prob = torch.where(inside, torch.exp(sc - m), 0.0)
        ls.append(prob.sum(-1, keepdim=True))
        if k_scales is not None:
            prob = prob * vsc
        accs.append(torch.einsum("bhgs,bhsd->bhgd", prob, vc))
        ms.append(m)
    m_all = torch.stack(ms)  # [S, B, Hkv, G, 1]
    w = torch.exp(m_all - m_all.amax(0))
    lsum = (torch.stack(ls) * w).sum(0)
    acc = (torch.stack(accs) * w).sum(0)
    out = torch.where(lsum > 0, acc / torch.where(lsum > 0, lsum, 1.0), 0.0)
    return out.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_count(batch: int, hkv: int, maxp: int, page: int, n_sm: int) -> int:
    """The kernel's n_splits from shapes alone (never from seq_lens, which
    lie on the device): enough (slot, kv head, split) blocks for
    BLOCKS_PER_SM per SM, at most MAX_AUTO_SPLITS, and no more splits than a
    full table has ROW_ALIGN-row ranges."""
    want = -(-BLOCKS_PER_SM * n_sm // (batch * hkv))
    return max(1, min(want, MAX_AUTO_SPLITS, -(-maxp * page // ROW_ALIGN)))


def host_split_count(batch: int, hkv: int, maxp: int, page: int,
                     device: torch.device) -> Optional[int]:
    """The n_splits `paged_decode_attention` picks for a call of `batch`
    rows on `device` (None on the CPU, where the plain version runs): a
    caller that launches more rows but must cut each row as a call of
    `batch` rows cuts it passes this as `n_splits`."""
    if device.type != "cuda":
        return None
    return split_count(batch, hkv, maxp, page, _sm_count(device.index or 0))


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
    n_splits: Optional[int] = None,
) -> torch.Tensor:
    """-> [B, Hkv, G, d].  Every seq_len must be >= 1 and its pages must be in
    the table.  int8 pools take k_scales and v_scales.  `n_splits` forces
    the kernel's split count (tests); None lets `split_count` choose."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales go together")
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages, page_table, seq_lens,
                                                sliding_window, scale, k_scales, v_scales)
    return _launch(q, k_pages, v_pages, page_table, seq_lens, sliding_window, scale,
                   k_scales, v_scales, n_splits)


paged_decode_attention.launches = 0  # launches over bf16/f32 pools
paged_decode_attention.int8_launches = 0  # launches over int8 pools


def _launch(q, k_pages, v_pages, page_table, seq_lens, sliding_window, scale, k_scales,
            v_scales, n_splits):
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
    if d % 16 or d > 128 or g > 8:
        raise ValueError(f"{name}: head_dim must be a multiple of 16 up to 128 and the group "
                         f"size at most 8; got d={d} G={g}")
    for t in (q, k_pages, v_pages, page_table, seq_lens, *scales):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{name}: the pools must start on 16-byte boundaries")
    maxp, page = page_table.shape[1], k_pages.shape[2]
    if n_splits is None:
        n_splits = host_split_count(b, hkv, maxp, page, q.device)
    if not 1 <= n_splits <= MAX_SPLITS:
        raise ValueError(f"{name}: n_splits must be in 1..{MAX_SPLITS}, got {n_splits}")
    scale = d**-0.5 if scale is None else scale
    window = -1 if sliding_window is None else int(sliding_window)
    kv_code = _build.INT8_CODE if quant else _build.DTYPE_CODES[q.dtype]
    out = torch.empty_like(q)
    part = torch.empty((b, hkv, n_splits, g, d + 2), dtype=torch.float32, device=q.device)
    fn = _build.kernel("usdm_paged_decode", _ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             k_scales.data_ptr() if quant else None, v_scales.data_ptr() if quant else None,
             page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), part.data_ptr(), b,
             hkv, g, d, k_pages.shape[1], page, maxp, window, float(scale), n_splits,
             _build.DTYPE_CODES[q.dtype], kv_code, _build.stream_ptr(q.device))
    _build.check(err, name)
    if quant:
        paged_decode_attention.int8_launches += 1
    else:
        paged_decode_attention.launches += 1
    return out
