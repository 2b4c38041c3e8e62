"""K6: the W8A8 decode matvec (kernel in csrc/stream_matvec.cu).

Port of usdm_tpu/ops/stream_matvec.py `stream_qmv`.  Layout contract: a
quantized weight is {"q": [Dout, Din] int8 contiguous, "s": [Dout] bf16}
("oi": one output row is one contiguous run of Din bytes).  y [M, Din],
M <= 16, is quantized per row to symmetric int8, the product runs
int8 x int8 -> int32, and the result is acc * ys * s in f32 (the epilogue
order of models/quant.py `qmm`, so qmm gives one function whatever routes
it), cast to `out_dtype`.

`stream_qmv` launches the CUDA kernel for CUDA tensors and runs
`stream_qmv_reference` for CPU tensors.  The kernel quantizes the rows into
shared memory on the way to the products (qx never reaches device
memory); the wrapper makes one allocation, `out`, whose buffer also holds
the 16 floats of row scales that a pre-pass launch writes from 3 rows on.
The kernel picks its route by M: at 1-2 rows __dp4a on the CUDA cores, the
block finding the row scales itself; from 3 rows the int8 tensor cores,
Din split over a thread-block cluster.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from usdm_tpu_torch.ops import _build

MAX_ROWS = 16  # rows of y the kernel takes (decode batches)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_ROUTE_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
ROUTES = (1, 2)  # the int8 tensor cores; __dp4a on the CUDA cores (at most 2 rows)


def symmetric_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-8), the scale of symmetric int8, with an IEEE
    division on every device: PyTorch's CUDA kernels divide by a Python
    number through its reciprocal, which rounds differently.  The divisor is
    filled on the device (no host copy), so a CUDA graph can capture it."""
    return torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)


def quantize_rows(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8: y [M, Din] -> (qy int8 [M, Din],
    ys f32 [M, 1]), round half to even."""
    yf = y.float()
    ys = symmetric_scale(yf.abs().amax(dim=-1, keepdim=True))
    return torch.clamp(torch.round(yf / ys), -127, 127).to(torch.int8), ys


def int_matmul_reference(qy: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact integer product qy [M, Din] x q [Dout, Din]^T, formed in float64:
    every partial sum is an integer below 127^2 * Din < 2^53.  (A float32
    product is not exact once partial sums pass 2^24.)"""
    return qy.double() @ q.double().t()


def epilogue(acc: torch.Tensor, ys: torch.Tensor, s: torch.Tensor,
             out_dtype: torch.dtype) -> torch.Tensor:
    """acc [M, Dout] (exact integers) -> (acc * ys) * s in f32, in out_dtype."""
    return (acc.float() * ys * s.float()).to(out_dtype)


def stream_qmv_reference(y: torch.Tensor, w: Dict[str, torch.Tensor],
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: quantize_rows, the exact integer product, epilogue."""
    qy, ys = quantize_rows(y)
    return epilogue(int_matmul_reference(qy, w["q"]), ys, w["s"], out_dtype)


def stream_qmv(y: torch.Tensor, w: Dict[str, torch.Tensor],
               out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y [M, Din] @ W for an "oi" quantized weight -> [M, Dout] out_dtype."""
    if y.device.type == "cpu":
        return stream_qmv_reference(y, w, out_dtype)
    return _launch(y, w["q"], w["s"], out_dtype, 0)


stream_qmv.launches = 0


def _stream_qmv_route(y: torch.Tensor, w: Dict[str, torch.Tensor], out_dtype: torch.dtype,
                      route: int) -> torch.Tensor:
    """stream_qmv on CUDA tensors with the kernel's route forced (one of
    ROUTES) instead of planned: for the tests and chip_smoke's route A/B,
    which hold every route to the same bits and times."""
    if route not in ROUTES or (route == 2 and y.shape[0] > 2):
        raise ValueError(f"stream_qmv: route {route} is not one of {ROUTES} (2: at most 2 "
                         f"rows), M={y.shape[0]}")
    return _launch(y, w["q"], w["s"], out_dtype, route)


def _launch(y, q, s, out_dtype, route):
    name = "stream_qmv"
    _build.require_cuda(name, y, q, s)
    if y.dim() != 2 or q.dim() != 2 or s.shape != (q.shape[0],) or y.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: y {tuple(y.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)} "
                         f"do not match [M, Din] x [Dout, Din], [Dout]")
    m, din = y.shape
    if not 1 <= m <= MAX_ROWS or din % 16:
        raise ValueError(f"{name}: takes 1..{MAX_ROWS} rows and Din a multiple of 16, got "
                         f"M={m} Din={din}")
    if (y.dtype not in _build.DTYPE_CODES or out_dtype not in _build.DTYPE_CODES
            or q.dtype != torch.int8 or s.dtype != torch.bfloat16):
        raise TypeError(f"{name}: y and out float32 or bfloat16, q int8, s bfloat16; got "
                        f"{y.dtype}, {out_dtype}, {q.dtype}, {s.dtype}")
    if not all(a.is_contiguous() for a in (y, q, s)) or y.data_ptr() % 16 or q.data_ptr() % 16:
        # the kernel reads 16 bytes of a row of y and q at once
        raise ValueError(f"{name}: operands must be contiguous, y and q 16-byte aligned")
    dout = q.shape[0]
    # one allocation: out, then (16-byte aligned) the pre-pass's row scales,
    # private to this call, so concurrent calls and graphs share nothing
    n_out = m * dout * out_dtype.itemsize
    ws_at = -(-n_out // 16) * 16
    buf = torch.empty(ws_at + 4 * MAX_ROWS, dtype=torch.uint8, device=y.device)
    out = buf[:n_out].view(out_dtype).view(m, dout)
    codes = (m, dout, din, _build.DTYPE_CODES[y.dtype], _build.DTYPE_CODES[out_dtype])
    ptrs = (y.data_ptr(), q.data_ptr(), s.data_ptr(), buf.data_ptr() + ws_at, out.data_ptr())
    stream = _build.stream_ptr(y.device)
    if route:
        err = _build.kernel("usdm_stream_qmv_route", _ROUTE_ARGTYPES)(*ptrs, *codes, route,
                                                                      stream)
    else:
        err = _build.kernel("usdm_stream_qmv", _ARGTYPES)(*ptrs, *codes, stream)
    _build.check(err, name)
    stream_qmv.launches += 1
    return out
