"""X2: the W4A8 matvec over a packed int4 weight (csrc/int4_matvec.cu).

Port of scripts/exp_int4_pallas.py's Pallas kernel `qmv4_kernel` (wrapper
`qmv4`), the same function as the nested `qmv4_kernel` of
scripts/exp_int4.py.  A weight W [Dout, Din] of 4-bit two's complement
values ("oi" layout) is packed by `pack_halves` into [Dout, Din / 2] uint8:
the low nibble of byte j is W[:, j], the high nibble W[:, Din / 2 + j]
(exp_int4.py's `pack_adj`).  Then

  qmv4(qy [B, Din] int8, packed, s [Dout] f32) = f32(qy @ W^T in int32) * s

with no activation scale inside, B <= 16.  The kernel equals its plain
version bit for bit.  `pack_pairs` / `unpack_pairs` are exp_int4.py's other
layout (`pack` / `unpack`: neighbouring rows of an "io" weight share a
byte), which its `w4a8_unpack` formulation unpacks before an int8 product.

`qmv4` launches the CUDA kernel for CUDA tensors and runs `qmv4_reference`
for CPU tensors.  The JAX package serves no int4 and neither does the port:
this is a probe.
"""

from __future__ import annotations

import ctypes

import torch

from usdm_tpu_torch.ops import _build
from usdm_tpu_torch.ops.stream_matvec import int_matmul_reference

MAX_ROWS = 16
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _nibbles(q: torch.Tensor) -> torch.Tensor:
    return (q.to(torch.int16) & 0xF).to(torch.uint8)


def _signed(n: torch.Tensor) -> torch.Tensor:
    n = n.to(torch.int16)
    return torch.where(n >= 8, n - 16, n).to(torch.int8)


def pack_halves(q: torch.Tensor) -> torch.Tensor:
    """[..., Dout, Din] int8 in [-8, 7] -> [..., Dout, Din / 2] uint8: low
    nibble = the first half of the input axis, high nibble = the second."""
    dh = q.shape[-1] // 2
    return (_nibbles(q[..., :dh]) | (_nibbles(q[..., dh:]) << 4)).contiguous()


def unpack_halves(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_halves: [..., Dout, Din / 2] uint8 -> [..., Dout, Din] int8."""
    return torch.cat([_signed(p & 0xF), _signed(p >> 4)], dim=-1)


def pack_pairs(q: torch.Tensor) -> torch.Tensor:
    """[..., 2k, Dout] int8 in [-8, 7] -> [..., k, Dout] uint8: rows 2i and
    2i + 1 in the low and high nibbles of row i."""
    return (_nibbles(q[..., 0::2, :]) | (_nibbles(q[..., 1::2, :]) << 4)).contiguous()


def unpack_pairs(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_pairs: [..., k, Dout] uint8 -> [..., 2k, Dout] int8."""
    both = torch.stack([_signed(p & 0xF), _signed(p >> 4)], dim=-2)
    return both.reshape(*p.shape[:-2], -1, p.shape[-1])


def check_args(qy: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> None:
    """Raise on what neither version takes."""
    if qy.dtype != torch.int8 or wp.dtype != torch.uint8 or s.dtype != torch.float32:
        raise TypeError(f"qmv4: qy int8, packed weight uint8, s float32; got {qy.dtype}, "
                        f"{wp.dtype}, {s.dtype}")
    if qy.dim() != 2 or wp.dim() != 2 or qy.shape[1] != 2 * wp.shape[1] \
            or s.shape != (wp.shape[0],):
        raise ValueError(f"qmv4: qy {tuple(qy.shape)}, packed {tuple(wp.shape)}, s "
                         f"{tuple(s.shape)} do not match [B, Din], [Dout, Din / 2], [Dout]")
    if not 1 <= qy.shape[0] <= MAX_ROWS or wp.shape[1] % 16:
        raise ValueError(f"qmv4: takes 1..{MAX_ROWS} rows and Din a multiple of 32, got "
                         f"B={qy.shape[0]} Din={qy.shape[1]}")


def qmv4_reference(qy: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack, the exact integer product (float64), * s."""
    return int_matmul_reference(qy, unpack_halves(wp)).float() * s


def qmv4(qy: torch.Tensor, wp: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """qy [B, Din] int8 @ packed W [Dout, Din / 2] uint8 -> [B, Dout] f32 * s."""
    check_args(qy, wp, s)
    if qy.device.type == "cpu":
        return qmv4_reference(qy, wp, s)
    _build.require_cuda("qmv4", qy, wp, s)
    if not all(a.is_contiguous() for a in (qy, wp, s)) or qy.data_ptr() % 16 \
            or wp.data_ptr() % 16:
        raise ValueError("qmv4: operands must be contiguous, qy and the weight 16-byte aligned")
    out = torch.empty((qy.shape[0], wp.shape[0]), dtype=torch.float32, device=qy.device)
    fn = _build.kernel("usdm_qmv4", _ARGTYPES)
    err = fn(qy.data_ptr(), wp.data_ptr(), s.data_ptr(), out.data_ptr(), qy.shape[0],
             wp.shape[0], wp.shape[1], _build.stream_ptr(qy.device))
    _build.check(err, "qmv4")
    qmv4.launches += 1
    return out


qmv4.launches = 0
