"""X3: the weight-streaming probes (kernel in csrc/stream_probe.cu).

Port of scripts/exp_stream_variants.py's Pallas kernels, `make_kernel(mode,
bpad)` and `run_multi_dma`'s.  One call streams all of an int8 weight
w [F, D] and returns out [1, 128] f32, the sum over its tiles of BF rows,
in tile order and in f32, of g(tile):

  dma_only  tile[0, :128]                    (the copy: loads, no compute)
  dot       (x @ tile^T)[0, :128], int8 products summed in int32; x is
            [bpad, D] int8, bpad 1, 8 or 32 (the TPU script's dot_b1,
            dot_b8, dot_b32; its "wlhs" is the same function)
  vpu       the same product as f32 products summed in f32 (bpad 1)
  dot_bf16  the same product with the operands through bf16, f32 sums

`loads` (1, 2, 4, 8) sets how many 16-byte loads each lane has in flight,
the analogue of run_multi_dma's `nch` concurrent DMAs.  Every mode equals
its plain version bit for bit: `vpu` and `dot_bf16` sum their exact integer
products in the kernel's f32 order (`lane_order_rows`), which rounds only
in a warp's 5-level shuffle tree and in the tile fold.

`stream_probe` launches the CUDA kernel for CUDA tensors and runs
`stream_probe_reference` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from usdm_tpu_torch.ops import _build

MODES = {"dma_only": 0, "dot": 1, "vpu": 2, "dot_bf16": 3}
BPADS = {"dma_only": (1,), "dot": (1, 8, 32), "vpu": (1,), "dot_bf16": (1,)}
LOADS = (1, 2, 4, 8)
OUT = 128  # output columns: the first 128 rows of every tile
SINK_LEN = 4096  # ints of per-block scratch; more than the blocks that fit at once
LANES, CHUNK = 32, 16  # a warp's lanes; bytes per load (lane l loads chunks l, l + 32, ...)
MAX_F32_D = 32768  # vpu, dot_bf16: a lane's share of a row, <= 2^24, stays exact in f32

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def check_args(x: torch.Tensor, w: torch.Tensor, mode: str, bf: int, loads: int = 8) -> None:
    """Raise on what neither version takes."""
    if mode not in MODES:
        raise ValueError(f"stream_probe: mode {mode!r} is not one of {sorted(MODES)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"stream_probe: x and w must be int8, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"stream_probe: x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         f"match [bpad, D] and [F, D]")
    f, d = w.shape
    if x.shape[0] not in BPADS[mode]:
        raise ValueError(f"stream_probe: mode {mode} takes bpad in {BPADS[mode]}, got "
                         f"{x.shape[0]}")
    if bf < OUT or f % bf or d % 16:
        raise ValueError(f"stream_probe: needs BF >= {OUT} dividing F and D a multiple of 16, "
                         f"got F={f} D={d} BF={bf}")
    if loads not in LOADS:
        raise ValueError(f"stream_probe: loads in flight must be one of {LOADS}, got {loads}")
    if mode in ("vpu", "dot_bf16") and d > MAX_F32_D:
        raise ValueError(f"stream_probe: {mode} takes D <= {MAX_F32_D}, got {d}")


def lane_order_rows(x0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Every row of w dotted with x0 [D] in f32, in the kernel's order: the
    products are exact integers; each lane's share (its 16-byte chunks, D
    zero-padded to whole warps) sums exactly below 2^24; then the 32 shares
    are added as a warp's xor shuffle tree adds them into lane 0 (lane l +
    lane l + 16, then + 8, 4, 2, 1), the only adds that round.  [F] f32."""
    f, d = w.shape
    prod = w.float() * x0.float()
    pad = -d % (LANES * CHUNK)
    lanes = torch.nn.functional.pad(prod, (0, pad)).view(f, -1, LANES, CHUNK).sum(dim=(1, 3))
    while lanes.shape[1] > 1:
        half = lanes.shape[1] // 2
        lanes = lanes[:, :half] + lanes[:, half:]
    return lanes[:, 0]


def tile_outputs_reference(x: torch.Tensor, w: torch.Tensor, mode: str,
                           bf: int) -> torch.Tensor:
    """g(tile) of every tile, [NT, 128] f32, computed over all of w and x
    and then cut, as the TPU kernel does (int products exact in float64)."""
    f, d = w.shape
    if mode == "dma_only":
        rows = w
    elif mode == "dot":
        rows = (x.double() @ w.double().t())[0].float()  # exact, then rounded to f32
    elif mode == "vpu":
        rows = lane_order_rows(x[0], w)
    else:  # dot_bf16: int8 operands are exact in bf16
        rows = lane_order_rows(x[0].bfloat16(), w.bfloat16())
    if mode == "dma_only":
        return rows.view(f // bf, bf, d)[:, 0, :OUT].float()
    return rows.view(f // bf, bf)[:, :OUT].contiguous()


def fold_tiles(tiles: torch.Tensor) -> torch.Tensor:
    """[NT, 128] -> [1, 128]: acc = 0; acc = acc + tile, in tile order, f32."""
    acc = torch.zeros(1, OUT, dtype=torch.float32, device=tiles.device)
    for t in tiles:
        acc = acc + t
    return acc


def stream_probe_reference(x: torch.Tensor, w: torch.Tensor, mode: str,
                           bf: int = 1024) -> torch.Tensor:
    """Plain version: every tile's output, then the fold in tile order."""
    check_args(x, w, mode, bf)
    return fold_tiles(tile_outputs_reference(x, w, mode, bf))


def stream_probe(x: torch.Tensor, w: torch.Tensor, mode: str, bf: int = 1024,
                 loads: int = 8) -> torch.Tensor:
    """Stream w [F, D] int8 once -> [1, 128] f32 (see the module docstring)."""
    check_args(x, w, mode, bf, loads)
    if w.device.type == "cpu":
        return stream_probe_reference(x, w, mode, bf)
    return _launch(x, w, mode, bf, loads)


stream_probe.launches = 0


def _launch(x, w, mode, bf, loads):
    name = "stream_probe"
    _build.require_cuda(name, x, w)
    if not (x.is_contiguous() and w.is_contiguous()) or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"{name}: x and w must be contiguous and 16-byte aligned")
    f, d = w.shape
    part = torch.empty((f // bf, OUT), dtype=torch.float32, device=w.device)
    sink = torch.empty(SINK_LEN, dtype=torch.int32, device=w.device)
    out = torch.empty((1, OUT), dtype=torch.float32, device=w.device)
    fn = _build.kernel("usdm_stream_probe", _ARGTYPES)
    err = fn(x.data_ptr(), w.data_ptr(), part.data_ptr(), sink.data_ptr(), out.data_ptr(),
             f, d, bf, MODES[mode], x.shape[0], loads, SINK_LEN, _build.stream_ptr(w.device))
    _build.check(err, name)
    stream_probe.launches += 1
    return out
