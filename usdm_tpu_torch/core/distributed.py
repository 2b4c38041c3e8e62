"""Process groups for tensor-parallel serving, and the trainers' launch flags.

Port of usdm_tpu/core/distributed.py.  usdm_tpu calls
`jax.distributed.initialize` once per host and one controller drives every
device; the port runs SPMD, one process per GPU, over
`torch.distributed.init_process_group`: NCCL on the card, gloo on the CPU,
rank r bound to cuda:r (torchrun's LOCAL_RANK where it is set) before NCCL
starts.  `--coordinator host:port` is the tcp:// rendezvous;
`num_processes` / `process_id` are the world size and the rank.

Tensor-parallel serving (engine/tp.py) runs over these groups.  Training
still runs on one GPU in one process: the trainers parse usdm_tpu's
multi-host flags and `refuse_unported` raises NotImplementedError by name
for anything beyond one device (--dp or --tp > 1, a coordinator, several
processes or slices) until multi-GPU training is ported (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

UNPORTED = "multi-GPU training is not ported to usdm_tpu_torch yet (ROADMAP Queue 1 item 10)"


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="cuda") -> None:
    """Join (or form) the process group of this run: backend nccl for a
    `cuda` device, gloo for `cpu`.  `coordinator_address` (rank 0's
    host:port) with `num_processes` and `process_id` rendezvous over TCP;
    with no address, torchrun's environment (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  A one-process group is formed too (collectives over
    it are real NCCL or gloo calls).  On the card this process first binds
    its GPU, and the NCCL communicator is warmed by one all-reduce (NCCL
    creates it lazily, at the first collective).  A second call is a no-op."""
    if dist.is_initialized():
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("initialize(device='cuda'): CUDA is not available")
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % n)))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://", world_size=num_processes,
                                rank=process_id)
    if backend == "nccl":
        warm = torch.ones(1, device=torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(warm)
        torch.cuda.synchronize()


def initialize_from_args(args, device="cuda") -> None:
    """Call `initialize` iff the CLI flags ask for more than one process."""
    if args.coordinator is not None or (args.num_processes or 0) > 1:
        initialize(args.coordinator, args.num_processes, args.process_id, device)


def process_info() -> dict:
    """This process's place in the group (one process, one device, when no
    group is initialized)."""
    on = dist.is_initialized()
    count = dist.get_world_size() if on else 1
    return {"process_index": dist.get_rank() if on else 0, "process_count": count,
            "local_devices": torch.cuda.device_count() or 1, "global_devices": count}


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def add_cli_args(p) -> None:
    """usdm_tpu's multi-host launch flags (parsed; refused beyond one process)."""
    g = p.add_argument_group("distributed (multi-host launch; not ported)")
    g.add_argument("--coordinator", default=None, help="rank-0 host:port (refused)")
    g.add_argument("--num_processes", type=int, default=None,
                   help="total process count (refused above 1)")
    g.add_argument("--process_id", type=int, default=None, help="this host's rank")
    g.add_argument("--num_slices", type=int, default=1, help="multi-slice pods (refused above 1)")


def refuse_unported(args) -> None:
    """Raise NotImplementedError naming the flag when a trainer's command
    line asks for more than one device or process."""
    for flag, bad in (("--dp", getattr(args, "dp", 1) > 1), ("--tp", getattr(args, "tp", 1) > 1),
                      ("--coordinator", args.coordinator is not None),
                      ("--num_processes", (args.num_processes or 1) > 1),
                      ("--num_slices", args.num_slices > 1)):
        if bad:
            raise NotImplementedError(f"{flag}: {UNPORTED}")
