"""K6 against qmm's plain numerics, and its 16-layer up/down chain's rate.

    python -m usdm_tpu_torch.scripts.exp_stream_qmv          # on the card
    python -m usdm_tpu_torch.scripts.exp_stream_qmv --device cpu --layers 2 --d 256 --f 512

Port of scripts/exp_stream_qmv.py.  (1) One [D 4096 -> F 14336] weight,
N(0, 0.02^2) from seed 0, quantized by `quantize_weight`: K6
(`stream_qmv`, the "oi" layout q [F, D]) against qmm's plain numerics in
the "io" layout (the rows quantized, the exact integer product with q^T
[D, F], the epilogue), at M 1 and M 4, bf16 rows from seed 0: the max abs
error and its ratio to the largest output, in bf16 out (bound: one bf16
ulp of each value) and in f32 out (bound: 0, the integer product is exact
and the epilogue the same).  (2) The up/down MLP chain over 16 layers
(2 x 58.7 MB of int8 weights a layer) through K6, from a CUDA graph: ms and
GB/s over the weight bytes.  The chain is `exp_matvec`'s `stream_qmv_oi`,
called from there.  Prints one JSON line.  Without a card it raises;
`--device cpu` with small `--layers/--d/--f` runs the plain versions (a
plumbing check: its times are no device metric).
"""

from __future__ import annotations

import torch

from usdm_tpu_torch.models.quant import quantize_weight
from usdm_tpu_torch.ops.stream_matvec import epilogue, quantize_rows, stream_qmv
from usdm_tpu_torch.scripts import common as C
from usdm_tpu_torch.scripts import exp_matvec


def io_reference(y: torch.Tensor, qw: dict, out_dtype: torch.dtype) -> torch.Tensor:
    """qmm's numerics over the "io" layout: y's rows quantized, the exact
    integer product with q^T [Din, Dout] (formed in float64), the epilogue."""
    qy, ys = quantize_rows(y)
    return epilogue(qy.double() @ qw["q"].t().double(), ys, qw["s"], out_dtype)


def check(y: torch.Tensor, qw: dict) -> dict:
    """K6 on `y` against io_reference, bf16 and f32 out."""
    out = {}
    for dt, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        got, want = stream_qmv(y, qw, dt).float(), io_reference(y, qw, dt).float()
        err = (got - want).abs().max().item()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
        out[name] = {"max_abs_err": err, "rel": err / (want.abs().max().item() + 1e-9),
                     "bound": "one bf16 ulp of each value" if dt == torch.bfloat16 else 0.0,
                     "ok": bool(((got - want).abs() <= ulp).all()) if dt == torch.bfloat16
                     else err == 0.0}
    return out


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev = C.device(args.device)
    d, f = args.d, args.f
    gen = torch.Generator(device=dev).manual_seed(0)
    qw = quantize_weight(torch.randn(d, f, generator=gen, device=dev) * 0.02)
    results = {}
    for m in (1, 4):
        results[f"check_m{m}"] = check(
            torch.randn(m, d, generator=gen, device=dev).bfloat16(), qw)
    del qw
    w = exp_matvec.make_weights(d, f, args.layers, dev)
    upT = w["up"].transpose(1, 2).contiguous()
    dnT = w["dn"].transpose(1, 2).contiguous()
    del w["up"], w["dn"]
    C.run(results, "stream_qmv_chain",
          lambda: exp_matvec.k6_chain(w["x"], upT, dnT, w["s_up"], w["s_dn"]), dev,
          2 * d * f * args.layers)
    line = C.emit("exp_stream_qmv", dev, args, results)
    bad = [k for k, v in results.items() if k.startswith("check") and
           not all(r["ok"] for r in v.values())]
    if bad:
        raise AssertionError(f"exp_stream_qmv: K6 leaves qmm's numerics beyond the bound: "
                             f"{ {k: results[k] for k in bad} }")
    return line


if __name__ == "__main__":
    main()
