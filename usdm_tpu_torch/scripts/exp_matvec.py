"""int8 matvec bandwidth probe: PyTorch formulations against the port's kernels.

    python -m usdm_tpu_torch.scripts.exp_matvec            # on the card
    python -m usdm_tpu_torch.scripts.exp_matvec --device cpu --layers 2 --d 256 --f 512

Port of scripts/exp_matvec.py.  The b=1 decode step's floor is the weight
read.  This times a realistic MLP chain (up [D, F], SiLU, down [F, D]; each
layer's output feeds the next, over L distinct layers) under each
formulation and reports the effective rate over the int8 weight bytes
(2 * D * F * L):

  w8a8_io          dynamic int8 rows @ "io" int8 weights via torch._int_mm
  w8a8_oi          the same with "oi" (transposed) weights
  bf16_deq         eager dequantize to bf16, then a bf16 matmul
  w8a8_io_b8       w8a8_io with 8 rows (amortization)
  pallas_bf16_512/1024, pallas_i8_512/1024
                   the TPU script's Pallas kernels, ported: X1a (bf16
                   activations, mv_io_bf16) and X1b (int8 activations,
                   mv_io_i8) with 512- or 1024-column blocks, io layout
  stream_qmv_oi    K6 (ops/stream_matvec.py), the port's serving route

torch._int_mm on CUDA takes more than 16 rows, so its rows are zero-padded
to 17.  On the card each chain is captured once in a CUDA graph and
replayed (the TPU script jits its chain), so its time is the device's, not
the host's dispatch of ~20 eager ops per layer.  Prints one JSON line.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from usdm_tpu_torch.ops.matvec_io import mv_io_bf16, mv_io_i8
from usdm_tpu_torch.ops.stream_matvec import stream_qmv
from usdm_tpu_torch.scripts import common as C


def make_weights(d: int, f: int, layers: int, dev: torch.device) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    up = torch.randint(-127, 127, (layers, d, f), generator=gen, device=dev, dtype=torch.int8)
    dn = torch.randint(-127, 127, (layers, f, d), generator=gen, device=dev, dtype=torch.int8)
    return {"up": up, "dn": dn,
            "s_up": torch.full((layers, f), 1 / 127, dtype=torch.bfloat16, device=dev),
            "s_dn": torch.full((layers, d), 1 / 127, dtype=torch.bfloat16, device=dev),
            "x": torch.randn(1, d, generator=gen, device=dev).bfloat16(),
            "x8": torch.randn(8, d, generator=gen, device=dev).bfloat16()}


def w8a8_chain(x, ups, dns, s_up, s_dn, mm):
    """The production W8A8 recipe; mm(qy int8, weight) -> int32."""
    y = x
    for i in range(len(s_up)):
        qy, ys = C.quant_act(y)
        h = F.silu(mm(qy, ups[i]).float() * ys * s_up[i].float())
        qh, hs = C.quant_act(h)
        y = (mm(qh, dns[i]).float() * hs * s_dn[i].float()).to(y.dtype)
    return y


def bf16_deq_chain(x, up, dn, s_up, s_dn):
    y = x
    for i in range(len(s_up)):
        h = F.silu((y @ up[i].bfloat16()).float() * s_up[i].float()).bfloat16()
        y = ((h @ dn[i].bfloat16()).float() * s_dn[i].float()).to(y.dtype)
    return y


def x1_bf16_chain(x, up, dn, s_up, s_dn, bf: int):
    """X1a's chain (the TPU script's p_bf16)."""
    y = x
    for i in range(len(s_up)):
        h = F.silu(mv_io_bf16(y, up[i], s_up[i], bf).float()).bfloat16()
        y = mv_io_bf16(h, dn[i], s_dn[i], bf)
    return y


def x1_i8_chain(x, up, dn, s_up, s_dn, bf: int):
    """X1b's chain (the TPU script's p_i8)."""
    y = x
    for i in range(len(s_up)):
        qy, ys = C.quant_act(y)
        h = F.silu(mv_io_i8(qy, up[i], s_up[i], bf).float() * ys).bfloat16()
        qh, hs = C.quant_act(h)
        y = (mv_io_i8(qh, dn[i], s_dn[i], bf).float() * hs).bfloat16()
    return y


def k6_chain(x, upT, dnT, s_up, s_dn):
    """K6 over "oi" weights: quantization inside, f32 out, SiLU, bf16."""
    y = x
    for i in range(len(s_up)):
        h = F.silu(stream_qmv(y, {"q": upT[i], "s": s_up[i]}, torch.float32)).bfloat16()
        y = stream_qmv(h, {"q": dnT[i], "s": s_dn[i]}, y.dtype)
    return y


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev = C.device(args.device)
    w = make_weights(args.d, args.f, args.layers, dev)
    up, dn, s_up, s_dn, x = w["up"], w["dn"], w["s_up"], w["s_dn"], w["x"]
    upT = up.transpose(1, 2).contiguous()  # [L, F, D] "oi"
    dnT = dn.transpose(1, 2).contiguous()
    n_bytes = 2 * args.d * args.f * args.layers
    results = {}

    def time(name, fn):
        C.run(results, name, fn, dev, n_bytes)

    time("w8a8_io", lambda: w8a8_chain(x, up, dn, s_up, s_dn, C.int_mm))
    time("w8a8_oi", lambda: w8a8_chain(x, upT, dnT, s_up, s_dn,
                                       lambda q, wt: C.int_mm(q, wt.t())))
    time("bf16_deq", lambda: bf16_deq_chain(x, up, dn, s_up, s_dn))
    time("w8a8_io_b8", lambda: w8a8_chain(w["x8"], up, dn, s_up, s_dn, C.int_mm))
    for bf in (512, 1024):
        time(f"pallas_bf16_{bf}", lambda bf=bf: x1_bf16_chain(x, up, dn, s_up, s_dn, bf))
        time(f"pallas_i8_{bf}", lambda bf=bf: x1_i8_chain(x, up, dn, s_up, s_dn, bf))
    time("stream_qmv_oi", lambda: k6_chain(x, upT, dnT, s_up, s_dn))
    return C.emit("exp_matvec", dev, args, results)


if __name__ == "__main__":
    main()
