"""X1: matvecs over an int8 weight in the "io" layout (csrc/matvec_io.cu).

Port of scripts/exp_matvec.py's Pallas kernels `_mv_bf16_kernel` (X1a,
`mv_io_bf16`) and `_mv_i8_kernel` (X1b, `mv_io_i8`), as `make_mv` launches
them.  The weight is q [Din, Dout] int8, one input row contiguous (usdm_tpu's
own layout of a quantized weight; the port's serving route, K6, re-lays it
as "oi"), with bf16 per-column scales s [Dout]; one activation row:

  mv_io_bf16(y [1, Din] bf16)  bf16((y @ bf16(q) in f32) * s)
  mv_io_i8(qx [1, Din] int8)   bf16(f32(qx @ q in int32) * s)

X1b equals its plain version bit for bit; X1a sums in another order and is
held within one bf16 ulp of its largest output + 1e-4.  `bf` (512 or 1024),
the Pallas tile width, is the columns of one CUDA block.

Each wrapper launches the CUDA kernel for CUDA tensors and runs its plain
version for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from usdm_tpu_torch.ops import _build
from usdm_tpu_torch.ops.stream_matvec import int_matmul_reference

TILES = (512, 1024)  # columns per block
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def check_args(name: str, x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
               x_dtype: torch.dtype, bf: int) -> None:
    """Raise on what neither version takes."""
    if x.dtype != x_dtype or q.dtype != torch.int8 or s.dtype != torch.bfloat16:
        raise TypeError(f"{name}: x {x_dtype}, q int8, s bfloat16; got {x.dtype}, {q.dtype}, "
                        f"{s.dtype}")
    if x.dim() != 2 or x.shape[0] != 1 or q.dim() != 2 or x.shape[1] != q.shape[0] \
            or s.shape != (q.shape[1],):
        raise ValueError(f"{name}: x {tuple(x.shape)}, q {tuple(q.shape)}, s {tuple(s.shape)} "
                         f"do not match [1, Din] x [Din, Dout], [Dout]")
    din, dout = q.shape
    if din % 4 or dout % 16 or bf not in TILES:
        raise ValueError(f"{name}: takes Din % 4 == 0, Dout % 16 == 0 and a tile of "
                         f"{TILES} columns, got Din={din} Dout={dout} bf={bf}")


def mv_io_bf16_reference(y: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """bf16((f32(y) @ f32(bf16(q))) * f32(s)), [1, Dout]."""
    return ((y.float() @ q.bfloat16().float()) * s.float()).bfloat16()


def mv_io_i8_reference(qx: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """bf16(f32(qx @ q exactly) * f32(s)), [1, Dout]."""
    return (int_matmul_reference(qx, q.t()).float() * s.float()).bfloat16()


def mv_io_bf16(y: torch.Tensor, q: torch.Tensor, s: torch.Tensor, bf: int = 512) -> torch.Tensor:
    """X1a: y [1, Din] bf16 @ q [Din, Dout] int8, scaled -> [1, Dout] bf16."""
    check_args("mv_io_bf16", y, q, s, torch.bfloat16, bf)
    if y.device.type == "cpu":
        return mv_io_bf16_reference(y, q, s)
    out = _launch("mv_io_bf16", y, q, s, bf, torch.float32)
    mv_io_bf16.launches += 1
    return out


def mv_io_i8(qx: torch.Tensor, q: torch.Tensor, s: torch.Tensor, bf: int = 512) -> torch.Tensor:
    """X1b: qx [1, Din] int8 @ q [Din, Dout] int8 in int32, scaled -> [1, Dout] bf16."""
    check_args("mv_io_i8", qx, q, s, torch.int8, bf)
    if qx.device.type == "cpu":
        return mv_io_i8_reference(qx, q, s)
    out = _launch("mv_io_i8", qx, q, s, bf, torch.int32)
    mv_io_i8.launches += 1
    return out


mv_io_bf16.launches = 0
mv_io_i8.launches = 0


def splits(din: int, dout: int, bf: int, n_sm: int) -> tuple:
    """(slices, rows per slice) of Din: about four blocks per SM, at least
    64 rows a slice, slices a multiple of 4 rows."""
    col_blocks = -(-dout // bf)
    ks = max(1, min(-(-4 * n_sm // col_blocks), din // 64))
    kchunk = -(-(-(-din // ks)) // 4) * 4
    return -(-din // kchunk), kchunk


def _launch(name, x, q, s, bf, acc_dtype):
    _build.require_cuda(name, x, q, s)
    if not all(a.is_contiguous() for a in (x, q, s)) or q.data_ptr() % 16 or x.data_ptr() % 4:
        raise ValueError(f"{name}: operands must be contiguous, q 16-byte and x 4-byte aligned")
    din, dout = q.shape
    ks, kchunk = splits(din, dout, bf, torch.cuda.get_device_properties(q.device)
                        .multi_processor_count)
    part = torch.empty((ks, dout), dtype=acc_dtype, device=q.device)
    out = torch.empty((1, dout), dtype=torch.bfloat16, device=q.device)
    fn = _build.kernel("usdm_mv_io", _ARGTYPES)
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), part.data_ptr(), out.data_ptr(), din,
             dout, bf, kchunk, int(x.dtype == torch.int8), _build.stream_ptr(q.device))
    _build.check(err, name)
    return out
