"""Process groups, the trainers' launch flags and their mesh, and failure
handling.

Port of usdm_tpu/core/distributed.py.  usdm_tpu calls
`jax.distributed.initialize` once per host and one controller drives every
device; the port runs SPMD, one process per GPU, over
`torch.distributed.init_process_group`: NCCL on the card, gloo on the CPU,
rank r bound to cuda:LOCAL_RANK (torchrun sets it; else the rank, so a
host without LOCAL_RANK must hold every rank) before NCCL starts.
`--coordinator host:port` is the tcp:// rendezvous; `--num_processes`
counts GPUs (usdm_tpu's counts hosts) and `--process_id` is this process's
rank.  Without a coordinator, torchrun's environment (MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK) forms the group.

Tensor-parallel serving (engine/tp.py) and the sharded trainers run over
these groups; `make_cli_mesh` builds a trainer's (data, model) or, with
--num_slices > 1, (replica, data, model) mesh (core/mesh.py).  A run that
asks for more ranks than the group has, or more ranks on a host than it has
CUDA devices, raises by name: sharded training never quietly becomes
single-process.  `guarded_training` writes an emergency checkpoint (rank 0,
from the gathered state) when a step raises, then re-raises.
"""

from __future__ import annotations

import contextlib
import os
import traceback
from typing import Optional

import torch
import torch.distributed as dist


def _bind_device(num_processes: Optional[int], rank: int) -> None:
    """Bind this rank's GPU (LOCAL_RANK, else the rank itself); raise by
    name where the host lacks it."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("initialize(device='cuda'): CUDA is not available")
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
    else:
        if (num_processes or 1) > n:
            raise ValueError(f"{num_processes} processes on one host need {num_processes} CUDA "
                             f"devices, this host has {n} (on several hosts give each process "
                             f"its LOCAL_RANK, as torchrun does)")
        local = rank
    if local >= n:
        raise ValueError(f"rank {rank} needs CUDA device {local}, this host has {n}")
    torch.cuda.set_device(local)


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
    if coordinator_address is not None and (num_processes is None or process_id is None):
        raise ValueError("--coordinator needs --num_processes and --process_id")
    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        raise ValueError(f"{num_processes or 'several'} processes need a rendezvous: "
                         "--coordinator host:port with --process_id, or torchrun's environment")
    dev = torch.device(device)
    if dev.type == "cuda":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        world = num_processes if num_processes is not None else int(
            os.environ.get("WORLD_SIZE", 1))
        _bind_device(world, rank)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coordinator_address is not None:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    else:
        dist.init_process_group(backend, init_method="env://", world_size=num_processes,
                                rank=process_id)
    if backend == "nccl":
        warm = torch.ones(1, device=torch.device("cuda", torch.cuda.current_device()))
        dist.all_reduce(warm)
        torch.cuda.synchronize()


def wants_group(args) -> bool:
    """Whether the flags (or torchrun's environment) ask for a process group."""
    return (args.coordinator is not None or (args.num_processes or 0) > 1
            or "WORLD_SIZE" in os.environ)


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
    """usdm_tpu's multi-host launch flags: one process per GPU."""
    g = p.add_argument_group("distributed (one process per GPU; or start the ranks with "
                             "torchrun)")
    g.add_argument("--coordinator", default=None, help="rank 0's host:port (tcp rendezvous)")
    g.add_argument("--num_processes", type=int, default=None,
                   help="total process count: one per GPU, over every host")
    g.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in [0, num_processes)")
    g.add_argument("--num_slices", type=int, default=1,
                   help=">1 builds a (replica, data, model) mesh (core.mesh.create_dcn_mesh): "
                        "DP across slices of consecutive ranks, FSDP/TP within")


def _refuse_cards(ranks: int, device) -> None:
    if torch.device(device).type != "cuda" or "LOCAL_RANK" in os.environ:
        return
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < ranks:
        raise ValueError(f"need {ranks} devices for a mesh of {ranks} ranks, have {n} CUDA "
                         f"devices")


def make_cli_mesh(args, device="cuda"):
    """The train mesh a CLI asked for -> a core.mesh.Mesh, or None for a
    one-process run that asks for no group (the single-device path).
    Forms the group first (`initialize`); `--dp -1` takes every rank left
    after --tp (and --num_slices).  Raises by name when the GPUs or the
    group's ranks fall short of dp x tp (x num_slices)."""
    from usdm_tpu_torch.core import mesh as MS

    tp = getattr(args, "tp", 1)
    dp = getattr(args, "dp", -1)
    asked = max(dp, 1) * tp * args.num_slices
    if not wants_group(args) and not dist.is_initialized():
        if asked > 1:
            _refuse_cards(asked, device)
            raise ValueError(f"a mesh of {asked} ranks (dp {dp}, tp {tp}, {args.num_slices} "
                             f"slices) needs {asked} processes: start them with torchrun, or "
                             f"--coordinator host:port --num_processes {asked} --process_id r")
        return None
    _refuse_cards(max(asked, args.num_processes or 1), device)
    initialize(args.coordinator, args.num_processes, args.process_id, device)
    if args.num_slices > 1:
        return MS.create_dcn_mesh(args.num_slices, dp=dp, tp=tp, device=device)
    return MS.create_mesh(dp=dp, tp=tp, device=device)


def finish() -> None:
    """Leave the process group, if one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def guarded_training(ckpt_dir: Optional[str], get_state, get_step):
    """Save an emergency checkpoint if training dies mid-run, then re-raise
    (usdm_tpu's guarded_training).  The save gathers a sharded state on every
    rank and rank 0 writes it (core/checkpoint.py save_train_state); a rank
    whose peers cannot join the gathers only logs the failure."""
    try:
        yield
    except KeyboardInterrupt:
        raise
    except Exception:
        traceback.print_exc()
        if ckpt_dir is not None:
            try:
                from usdm_tpu_torch.core.checkpoint import save_train_state

                state, step = get_state(), int(get_step())
                print(f"[guarded_training] saving emergency checkpoint at step {step}")
                save_train_state(ckpt_dir, state, step)
            except Exception:  # noqa: BLE001
                traceback.print_exc()
        raise
