"""int4 weight matvec probe: can the card stream half the bytes?

    python -m usdm_tpu_torch.scripts.exp_int4              # on the card
    python -m usdm_tpu_torch.scripts.exp_int4 --device cpu --layers 2 --d 256 --f 512

Port of scripts/exp_int4.py and scripts/exp_int4_pallas.py.  The b=1
decode step is weight-read-bound; if int4 weights stream at int8's rate the
step halves.  Times the exp_matvec MLP chain (D, F, L distinct layers) with:

  w8a8_io       the int8 recipe via torch._int_mm (rate over int8 bytes)
  w8a8_k6       K6 over "oi" int8 weights, the port's serving route (int8 bytes)
  w4a8_native   int4 weights in an XLA dot on the TPU: PyTorch has no int4
  w4a4_native   matmul, so both are reported as errors, not emulated
  w4a8_unpack   pairs packed along the input axis (`pack_pairs`), unpacked
                to int8 by plain ops, then torch._int_mm
  w4a8_pallas   the TPU scripts' Pallas kernel, ported: X2 (ops/int4_matvec.py,
                `qmv4`) over "oi" weights packed by halves (`pack_halves`)

Rates are over the int4 bytes (D * F * L) unless named; `w4a8_pallas` also
gives its int8-equivalent rate.  Before timing, two checks of X2 against the
exact integer product (exp_int4_pallas.py's and exp_int4.py's), whose
largest errors are printed; they must be 0.  On the card each chain is
captured once in a CUDA graph and replayed.  Prints one JSON line.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from usdm_tpu_torch.ops.int4_matvec import pack_halves, pack_pairs, qmv4, unpack_pairs
from usdm_tpu_torch.ops.stream_matvec import int_matmul_reference
from usdm_tpu_torch.scripts import common as C
from usdm_tpu_torch.scripts.exp_matvec import k6_chain, w8a8_chain

NO_INT4 = {"error": "no int4 matmul in PyTorch"}


def int4_chain(x, upp, dnp, s_up, s_dn):
    """X2's chain (the TPU scripts' w4a8_pallas)."""
    y = x
    for i in range(len(s_up)):
        qy, ys = C.quant_act(y)
        h = F.silu(qmv4(qy, upp[i], s_up[i]) * ys)
        qh, hs = C.quant_act(h)
        y = (qmv4(qh, dnp[i], s_dn[i]) * hs).bfloat16()
    return y


def unpack_chain(x, upp, dnp, s_up, s_dn):
    return w8a8_chain(x, upp, dnp, s_up, s_dn, lambda q, p: C.int_mm(q, unpack_pairs(p)))


def checks(d: int, f: int, dev: torch.device, gen: torch.Generator, x, up4, upp) -> dict:
    """X2 against the exact integer product: (1) exp_int4_pallas.py's, a
    random [F, D] int4 weight and int8 row, scale 1; (2) exp_int4.py's, the
    chain's first up projection on the quantized input row."""
    w = torch.randint(-8, 8, (f, d), generator=gen, device=dev, dtype=torch.int8)
    qy = torch.randint(-127, 127, (1, d), generator=gen, device=dev, dtype=torch.int8)
    ones = torch.ones(f, dtype=torch.float32, device=dev)
    want = int_matmul_reference(qy, w).float()
    err = (qmv4(qy, pack_halves(w), ones) - want).abs().max().item()
    qx, _ = C.quant_act(x)
    want = int_matmul_reference(qx, up4[0].t()).float()
    err_up = (qmv4(qx, upp[0], ones) - want).abs().max().item()
    print(f"max abs err: {err}; pallas max abs err vs int32 ref: {err_up}", flush=True)
    return {"max_abs_err": err, "chain_up_max_abs_err": err_up}


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev = C.device(args.device)
    d, f, layers = args.d, args.f, args.layers
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(1, d, generator=gen, device=dev).bfloat16()
    s_up = torch.full((layers, f), 1 / 127, dtype=torch.float32, device=dev)
    s_dn = torch.full((layers, d), 1 / 127, dtype=torch.float32, device=dev)
    i4_bytes, i8_bytes = d * f * layers, 2 * d * f * layers
    results = {}

    # int8 baselines
    up8 = torch.randint(-127, 127, (layers, d, f), generator=gen, device=dev, dtype=torch.int8)
    dn8 = torch.randint(-127, 127, (layers, f, d), generator=gen, device=dev, dtype=torch.int8)
    s_up8, s_dn8 = s_up.bfloat16(), s_dn.bfloat16()
    C.run(results, "w8a8_io", lambda: w8a8_chain(x, up8, dn8, s_up8, s_dn8, C.int_mm), dev,
          i8_bytes)
    up8, dn8 = up8.transpose(1, 2).contiguous(), dn8.transpose(1, 2).contiguous()
    C.run(results, "w8a8_k6", lambda: k6_chain(x, up8, dn8, s_up8, s_dn8), dev, i8_bytes)
    del up8, dn8

    results["w4a8_native"] = NO_INT4
    results["w4a4_native"] = NO_INT4

    # int4 values in "io" layout, packed two ways
    up4 = torch.randint(-8, 8, (layers, d, f), generator=gen, device=dev, dtype=torch.int8)
    dn4 = torch.randint(-8, 8, (layers, f, d), generator=gen, device=dev, dtype=torch.int8)
    upp, dnp = pack_pairs(up4), pack_pairs(dn4)  # [L, D/2, F], [L, F/2, D]
    C.run(results, "w4a8_unpack", lambda: unpack_chain(x, upp, dnp, s_up, s_dn), dev, i4_bytes)
    del upp, dnp
    upp = pack_halves(up4.transpose(1, 2))  # [L, F, D/2] "oi", halves in nibbles
    dnp = pack_halves(dn4.transpose(1, 2))  # [L, D, F/2]
    results["check"] = checks(d, f, dev, gen, x, up4, upp)
    if results["check"]["max_abs_err"] or results["check"]["chain_up_max_abs_err"]:
        raise AssertionError(f"X2 differs from the exact integer product: {results['check']}")
    del up4, dn4
    C.run(results, "w4a8_pallas", lambda: int4_chain(x, upp, dnp, s_up, s_dn), dev, i4_bytes)
    results["w4a8_pallas"]["gbps_int8_equivalent"] = 2 * results["w4a8_pallas"]["gbps"]
    return C.emit("exp_int4", dev, args, results)


if __name__ == "__main__":
    main()
