"""Weight-streaming probe: the card's read ceiling, and what compute costs on it.

    python -m usdm_tpu_torch.scripts.exp_stream_variants            # on the card
    python -m usdm_tpu_torch.scripts.exp_stream_variants --device cpu --layers 2 --d 256 --f 2048

Port of scripts/exp_stream_variants.py, through X3 (ops/stream_probe.py).
Each variant streams L distinct [F, D] int8 weights (one matrix per layer,
D * F * L bytes) and sums the per-layer [1, 128] results in f32:

  dma_only          loads every byte, computes nothing (the read rate)
  dot_b1/b8/b32     int8 dot of x [bpad, D] with every row (__dp4a)
  wlhs              the TPU's operand order of dot_b1: on the card the same
                    function and kernel as dot_b1, so not run again
  vpu               f32 products summed in f32
  dot_bf16          operands through bf16, summed in f32
  {mode}_c{n}_bf{bf}  run_multi_dma's sweep: n 16-byte loads in flight per
                    lane (the TPU's n concurrent DMAs per tile), tiles of bf rows

The variants above the sweep run with 8 loads in flight and tiles of 1024
rows; F must be a multiple of 2048.  On the card each chain is captured
once in a CUDA graph and replayed.  Prints one JSON line.
"""

from __future__ import annotations

import torch

from usdm_tpu_torch.ops.stream_probe import stream_probe
from usdm_tpu_torch.scripts import common as C

BF, LOADS = 1024, 8  # tile rows and loads in flight of make_kernel's variants
# (name, kernel mode, bpad) of make_kernel's variants
VARIANTS = (("dma_only", "dma_only", 1), ("dot_b1", "dot", 1), ("dot_b8", "dot", 8),
            ("dot_b32", "dot", 32), ("vpu", "vpu", 1), ("dot_bf16", "dot_bf16", 1))
# run_multi_dma's sweep (nch -> loads in flight), with depth 1 added
SWEEP = (("dma_only", 1, 1024), ("dma_only", 2, 1024), ("dma_only", 4, 1024),
         ("dma_only", 8, 1024), ("dot", 1, 1024), ("dot", 4, 1024), ("dot", 8, 1024),
         ("dma_only", 8, 2048), ("dot", 8, 2048))


def chain(x, ws, mode: str, bf: int, loads: int):
    """The TPU script's chain: c = 0; c = c + one(x, w) for each layer."""
    c = torch.zeros(1, 128, dtype=torch.float32, device=ws.device)
    for w in ws:
        c = c + stream_probe(x, w, mode, bf, loads)
    return c


def main(argv=None) -> dict:
    args = C.parser(__doc__).parse_args(argv)
    dev = C.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    ws = torch.randint(-127, 127, (args.layers, args.f, args.d), generator=gen, device=dev,
                       dtype=torch.int8)
    xs = {b: torch.randint(-127, 127, (b, args.d), generator=gen, device=dev, dtype=torch.int8)
          for b in (1, 8, 32)}
    n_bytes = args.d * args.f * args.layers
    results = {}
    for name, mode, bpad in VARIANTS:
        C.run(results, name, lambda m=mode, b=bpad: chain(xs[b], ws, m, BF, LOADS), dev, n_bytes)
    results["wlhs"] = {"same_function_and_kernel_as": "dot_b1"}
    for mode, loads, bf in SWEEP:
        C.run(results, f"{mode}_c{loads}_bf{bf}",
              lambda m=mode, n=loads, t=bf: chain(xs[1], ws, m, t, n), dev, n_bytes)
    return C.emit("exp_stream_variants", dev, args, results)


if __name__ == "__main__":
    main()
