"""Rate probe of the tensor-core flash kernels' products: what ldmatrix and
mma.sync allow at the kernels' operand mix, apart from loads, masks and softmax.

    python -m usdm_tpu_torch.scripts.exp_mma_mix

Blocks of 4 warps (csrc/mma_harness.cu) keep one Q, K and V tile of d 64 in
shared memory and repeat one 64-key step of the forward kernel's products
(S = Q.K^T, then P.V) on it.  Four forms: the kernels' own mix (a warp of 16
rows runs 36 ldmatrix.x4 for 64 mma.m16n8k16), the mma alone, the ldmatrix
alone, and the mix with each K/V fragment used for two 16-row tiles (36
ldmatrix.x4 per 128 mma), each at 1 to 4 blocks per SM.  Prints one JSON line:
per form and occupancy the time, the TFLOP/s of its mma, and the cycles of one
block's step at the card's maximum SM clock (nvidia-smi's clocks.max.sm; the
clock under load is not read).  CUDA only: the probe has no
plain version, it computes nothing a caller uses.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from usdm_tpu_torch.ops.flash_attention import MIX_MODES, MIX_TILE_BYTES, mma_mix_rate
from usdm_tpu_torch.scripts.common import device, device_info

MMA_FLOP = 2 * 16 * 8 * 16  # one mma.m16n8k16
MMA_PER_WARP_STEP = {"mix": 64, "mma": 128, "ldmatrix": 0, "reuse": 128}
SM_SMEM = 227 * 1024  # shared memory a block can use on an H100 SM


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=2000, help="steps per block")
    args = ap.parse_args(argv)
    dev = device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    mhz = float(smi.stdout.split()[0]) if smi.returncode == 0 and smi.stdout.split() else None
    results = {}
    for per_sm in (4, 3, 2, 1):
        # as much shared memory per block as leaves room for exactly per_sm blocks
        smem = max(MIX_TILE_BYTES, SM_SMEM // per_sm - 2048)
        for mode in MIX_MODES:
            mma_mix_rate(mode, 10, n_sm * per_sm, smem, dev)  # warm-up
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            mma_mix_rate(mode, args.iters, n_sm * per_sm, smem, dev)
            b.record()
            b.synchronize()
            ms = a.elapsed_time(b)
            flop = MMA_PER_WARP_STEP[mode] * MMA_FLOP * 4 * n_sm * per_sm * args.iters
            results[f"{mode}_{per_sm}_per_sm"] = {
                "ms": ms, "tflops": flop / ms / 1e9,
                "cycles_per_block_step": (ms * 1e-3 * mhz * 1e6 / (per_sm * args.iters)
                                          if mhz else None)}
    line = {"probe": "exp_mma_mix", "device": device_info(dev), "max_sm_clock_mhz": mhz,
            "iters": args.iters, "results": results}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
