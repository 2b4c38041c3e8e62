"""Tensor-parallel serving over torch.distributed.

Port of usdm_tpu/engine/tp.py.  usdm_tpu runs the paged decode and prefill
bodies inside a shard_map over a 1-D device mesh, with psum after the
row-split products and one all_gather of the vocab-split logits.  The port
runs SPMD, one process per GPU: every rank holds its slice of the weights
(heads and FFN column-split, wo and w_down row-split, lm_head split over
the vocab) and of the KV pool (its kv heads), runs the same bodies
(engine/paged_ops.py, `tp=` the mesh below) on its local shapes, and
`all_reduce`s the partial sums after wo and w_down and `gather_vocab`s the
logits.  The collectives are NCCL's on the card and gloo's on the CPU
(core/distributed.py forms the group).

The vocab need not divide by tp: `shard_params` pads lm_head with zero rows
up to a multiple of tp, and `gather_vocab` cuts the gathered logits back to
the true vocab before masks and sampling, so every token is the unsplit
model's.  (usdm_tpu refuses such a tp; USDM's 42,003-id vocab is odd.)

Every rank must take the same host decisions.  Rank 0 owns the requests:
EngineServer sends each loop turn's admissions, cancels and session
releases (`send`) before it runs the turn, and the other ranks run the same
turn on their engine (`follow`) until the server closes.  Sampled tokens
agree because every rank samples the same gathered logits with generators
seeded alike.  `launch` starts the ranks of an entry point.

Constraints, as usdm_tpu's: num_kv_heads % tp == 0 (GQA groups stay on one
rank) and intermediate_size % tp == 0.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from usdm_tpu_torch.core import distributed as D
from usdm_tpu_torch.models.mistral import COL, ROW  # column- and row-split projections
from usdm_tpu_torch.models.quant import is_quantized, out_dim


@dataclasses.dataclass(eq=False)
class TPMesh:
    """One rank's view of a tensor-parallel group: the compute group (NCCL
    or gloo), a gloo group for the host's control messages, this rank, the
    group's size and this rank's device.  `all_reduces` and `gathers` count
    the collectives the bodies ran over it."""

    group: Any
    ctrl: Any
    rank: int
    size: int
    device: torch.device
    all_reduces: int = 0
    gathers: int = 0


_CTRL: dict = {}  # compute group -> its gloo control group (made once, by every rank)


def rank_device(device) -> torch.device:
    """This rank's device: the bound GPU for "cuda", else `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def check_devices(tp: int, device) -> None:
    """Raise when `device` is a GPU and this host has fewer than tp of them."""
    if torch.device(device).type == "cuda":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < tp:
            raise ValueError(f"need {tp} devices for tp={tp}, have {n} CUDA devices")


def make_tp_mesh(tp: int, device="cuda") -> TPMesh:
    """The mesh of this rank in the initialized tp-rank group (every rank
    calls it).  Raises by name with fewer than tp GPUs for a cuda device,
    without an initialized group or with a group of another size: TP never
    becomes single-device by itself."""
    check_devices(tp, device)
    if not dist.is_initialized():
        raise RuntimeError(f"tp={tp} needs an initialized {tp}-rank torch.distributed group "
                           "(usdm_tpu_torch.core.distributed.initialize)")
    size = dist.get_world_size()
    if size != tp:
        raise ValueError(f"tp={tp} needs a {tp}-rank group, this one has {size} ranks")
    device = rank_device(device)
    backend = dist.get_backend()
    if (backend == "nccl") != (device.type == "cuda"):
        raise ValueError(f"tp on {device} needs a {'nccl' if device.type == 'cuda' else 'gloo'} "
                         f"group, this one is {backend}")
    group = dist.group.WORLD
    if group not in _CTRL:
        _CTRL[group] = group if backend == "gloo" else dist.new_group(backend="gloo")
    return TPMesh(group, _CTRL[group], dist.get_rank(), tp, device)


# ------------------------------------------------------------- the weights
def tp_param_specs() -> dict:
    """Inference TP: which dimension of each float leaf splits (None:
    replicated).  Heads and FFN column-split, wo and w_down row-split
    (partial sums all-reduced), lm_head [V, D] split over the vocab,
    embed (a gather) and the norms replicated."""
    layer = {k: None for k in ("ln1", "ln2")}
    layer.update({k: 1 for k in COL})
    layer.update({k: 0 for k in ROW})
    return {"embed": None, "layers": layer, "final_norm": None, "lm_head": 0}


def _leaf_spec(name: str, leaf):
    """A layer leaf's split: an int for a float weight; for a W8A8 leaf
    ("oi": q [Dout, Din], s [Dout]) a column split cuts q on dim 0 and s
    with it, a row split cuts q on dim 1 and keeps s whole."""
    dim = tp_param_specs()["layers"][name]
    if is_quantized(leaf) and dim is not None:
        return {"q": 0, "s": 0} if dim == 1 else {"q": 1, "s": None}
    return dim


def block(x: torch.Tensor, dim: Optional[int], tp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s block of `dim` (None: the whole tensor).  At tp 1 it
    is `x` itself, no copy."""
    if dim is None or tp == 1:
        return x
    n = x.shape[dim] // tp
    return x.narrow(dim, rank * n, n).contiguous()


def vocab_rows(vocab: int, tp: int) -> int:
    """lm_head rows a rank holds: the vocab padded to a multiple of tp, / tp."""
    return -(-vocab // tp)


def shard_vocab(w: torch.Tensor, tp: int, rank: int) -> torch.Tensor:
    """Rank `rank`'s rows of lm_head [V, D] in the vocab padded with zero
    rows to a multiple of tp (only the last rank's block holds padding)."""
    if tp == 1:
        return w
    n = vocab_rows(w.shape[0], tp)
    lo, hi = min(rank * n, w.shape[0]), min((rank + 1) * n, w.shape[0])
    part = w[lo:hi]
    if hi - lo < n:
        part = torch.cat([part, part.new_zeros(n - (hi - lo), w.shape[1])])
    return part.contiguous()


def shard_leaf(name: str, leaf, tp: int, rank: int):
    spec = _leaf_spec(name, leaf)
    if isinstance(spec, dict):
        return {k: block(v, spec[k], tp, rank) for k, v in leaf.items()}
    return block(leaf, spec, tp, rank)


def check_tp(cfg, tp: int) -> None:
    if cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(f"tp={tp} must divide num_kv_heads={cfg.num_kv_heads} and "
                         f"intermediate_size={cfg.intermediate_size}")


def shard_params(params: dict, cfg, tp: int, rank: int) -> dict:
    """Rank `rank`'s slices of a Mistral param tree (float or W8A8 leaves).
    cfg.vocab_size stays the true vocab: the bodies cut the gathered logits
    back to it."""
    check_tp(cfg, tp)
    return {"embed": params["embed"],
            "layers": [{k: shard_leaf(k, v, tp, rank) for k, v in lp.items()}
                       for lp in params["layers"]],
            "final_norm": params["final_norm"],
            "lm_head": shard_vocab(params["lm_head"], tp, rank)}


def local_params(params: dict, cfg, mesh: TPMesh) -> dict:
    """`params` as this rank's slices: sharded here when whole, passed
    through when they already are the rank's (a sharded checkpoint load,
    core/checkpoint.py load_mistral(shard=))."""
    check_tp(cfg, mesh.size)
    width = out_dim(params["layers"][0]["wq"])
    full = cfg.num_heads * cfg.head_dim
    if width == full:
        return shard_params(params, cfg, mesh.size, mesh.rank)
    if width * mesh.size != full or params["lm_head"].shape[0] != vocab_rows(cfg.vocab_size,
                                                                             mesh.size):
        raise ValueError(f"params are neither whole nor one of {mesh.size} ranks' slices "
                         f"(wq width {width}, heads x head_dim {full})")
    return params


def shard_kv(kv, tp: int, rank: int):
    """Rank `rank`'s kv heads of a paged pool: pages [Hkv, L*N, P, hd] on
    dim 0, int8 scales [L*N, Hkv, P] on dim 1."""
    scales = None if kv.k_scales is None else [block(s, 1, tp, rank)
                                               for s in (kv.k_scales, kv.v_scales)]
    return dataclasses.replace(kv, k_pages=block(kv.k_pages, 0, tp, rank),
                               v_pages=block(kv.v_pages, 0, tp, rank),
                               k_scales=scales and scales[0], v_scales=scales and scales[1])


# ------------------------------------------------------------- collectives
def all_reduce(x: torch.Tensor, mesh: TPMesh) -> torch.Tensor:
    """Sum a row-split product's partial sums over the ranks, in place."""
    dist.all_reduce(x, group=mesh.group)
    mesh.all_reduces += 1
    return x


def gather_vocab(logits: torch.Tensor, mesh: TPMesh, vocab: int) -> torch.Tensor:
    """Every rank's vocab block of `logits` [..., V/tp] -> [..., vocab]:
    one all-gather (into a list, which gloo and NCCL both take), then the
    padding rows cut off."""
    parts = [torch.empty_like(logits) for _ in range(mesh.size)]
    dist.all_gather(parts, logits.contiguous(), group=mesh.group)
    mesh.gathers += 1
    return torch.cat(parts, dim=-1)[..., :vocab]


# ------------------------------------------------------------- SPMD control
REQUEST_FIELDS = ("req_id", "prompt_ids", "allow_mask", "eos_id", "max_new_tokens", "top_k",
                  "top_p", "temperature", "seed", "session", "stream")


def send(mesh: TPMesh, msg) -> None:
    """Rank 0: one loop turn's host inputs to the other ranks (None: stop)."""
    dist.broadcast_object_list([msg], src=0, group=mesh.ctrl)


def recv(mesh: TPMesh):
    box = [None]
    dist.broadcast_object_list(box, src=0, group=mesh.ctrl)
    return box[0]


def turn_message(inbox, cancels, releases) -> tuple:
    """A loop turn as rank 0 sends it: each admitted request's fields, the
    cancelled request ids, the released sessions."""
    return ([{f: getattr(r, f) for f in REQUEST_FIELDS} for r in inbox], list(cancels),
            list(releases))


def follow(engine) -> None:
    """A rank other than 0: run rank 0's loop turns on `engine` until rank 0
    stops (EngineServer.close)."""
    from usdm_tpu_torch.engine.paged import Request
    from usdm_tpu_torch.engine.server import serve_turn

    while True:
        msg = recv(engine.mesh)
        if msg is None:
            return
        reqs, cancels, releases = msg
        serve_turn(engine, [Request(**f) for f in reqs], cancels, releases)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(addr: Optional[str], tp: int, rank: int, device, fn: Callable, args: tuple):
    D.initialize(addr, tp, rank, device)
    try:
        return fn(rank, *args)
    finally:
        dist.destroy_process_group()


def launch(tp: int, device, fn: Callable, *args):
    """Run `fn(rank, *args)` on every rank of a tp-process group -> rank 0's
    result.  Under torchrun (WORLD_SIZE set) this process is the rank
    torchrun gave it; otherwise it is rank 0 and starts tp - 1 workers
    (torch.multiprocessing, spawn) that meet it at a free local port.
    Raises by name, before any process starts, when a cuda device has
    fewer than tp GPUs.  `fn` must be a module-level function of a module
    the workers can import (not a test module)."""
    check_devices(tp, device)
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != tp:
            raise ValueError(f"tp={tp} under torchrun with WORLD_SIZE={os.environ['WORLD_SIZE']}")
        return _run_rank(None, tp, int(os.environ["RANK"]), device, fn, args)
    addr = f"localhost:{_free_port()}"
    ctx = torch.multiprocessing.get_context("spawn")
    workers = [ctx.Process(target=_run_rank, args=(addr, tp, r, device, fn, args))
               for r in range(1, tp)]
    for w in workers:
        w.start()
    ok = False
    try:
        out = _run_rank(addr, tp, 0, device, fn, args)
        ok = True
        return out
    finally:
        for w in workers:
            w.join(timeout=120 if ok else 10)
            if w.is_alive():
                w.terminate()
                w.join()
        if ok and any(w.exitcode for w in workers):
            raise RuntimeError(f"a tp worker failed: exit codes {[w.exitcode for w in workers]}")
