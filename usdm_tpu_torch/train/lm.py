"""LM training: the packed speech-text objective, on one GPU or sharded.

Port of usdm_tpu/train/lm.py.  usdm_tpu runs one jitted SPMD program over a
('data', 'model') mesh; here a step is eager and updates the parameters and
the AdamW moments in place (the counterpart of `donate_argnums`), on one
device or, given a core/mesh.py Mesh, on every rank of it (SPMD):

  * bf16 compute over f32 masters: the params are f32 tensors with
    requires_grad, and models/mistral.py casts each layer's weights to the
    compute dtype cfg.dtype inside the (rematerialized) layer function.  The
    CLIs train with cfg.dtype = COMPUTE_DTYPE on every path, from a
    checkpoint too (`load_masters`), where usdm_tpu's trainers compute in
    f32 after load_mistral(dtype="float32");
  * remat: torch.utils.checkpoint around each decoder layer (tc.remat);
  * the optimizer (`make_optimizer`): the gradient clipped to a global norm,
    then AdamW(b1 0.9, b2 0.95, eps 1e-8, weight decay 0.01 on every leaf)
    with optax's warmup-cosine (or linear) schedule, evaluated at the count
    before its increment, written here as optax computes it;
  * the host offload (`init_offload_state`), usdm_tpu's ZeRO-3 offload
    analog (its make_offload_train_step): the moments live in pinned host
    memory, and the same step streams them one leaf at a time host ->
    device -> host on two side streams, so the copies overlap the
    neighbouring leaves' updates.  Resident and offloaded moments take the
    same per-leaf arithmetic (`manual_adamw_update`);
  * sharding (`mesh=`): usdm_tpu's FSDP + TP layout (models/mistral.py
    param_specs; batch_spec, state_specs, offload_state_specs here).  Each
    rank holds its block of every master and moment; a layer's weights are
    all-gathered over data inside the rematerialized layer function (the
    recompute gathers again), the heads and FFN columns split over model
    with an all-reduce after wo and w_down, and each weight's gradient is
    reduce-scattered over data as a sum.  The loss is usdm_tpu's global
    one (the valid-token count all-reduced first); the norms' gradients
    are all-reduced over data, every gradient over replica on a
    multi-slice mesh; the clip norm sums each leaf's squared norm over
    every rank, a replicated leaf once.  AdamW is the per-leaf arithmetic
    on the shards.  The collectives are explicit calls (core/mesh.py), not
    torch's FSDP or DDP wrappers: the params are dicts of tensors, and the
    layer function casts and gathers each weight where it uses it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from usdm_tpu_torch.core import mesh as MS
from usdm_tpu_torch.core.config import MistralConfig, TrainConfig
from usdm_tpu_torch.core.tree import tree_leaves, tree_map, tree_map2
from usdm_tpu_torch.models import mistral as M

COMPUTE_DTYPE = "bfloat16"  # the trainers' compute dtype over f32 masters
ADAM_EPS = 1e-8


class _PinnedBuffer:
    """One f32 host buffer of exactly `numel` elements, zeroed and, when
    `pin`, page-locked by cudaHostRegister (torch's pinned allocator rounds
    each allocation up to a power of two: +14 % at the 7B's [4096, 14336]
    leaves, +56 % at the embedding); unregistered when this object goes."""

    def __init__(self, numel: int, pin: bool):
        self.tensor = torch.zeros(numel, dtype=torch.float32)
        self.ptr = None
        if pin:
            err = torch.cuda.cudart().cudaHostRegister(self.tensor.data_ptr(), numel * 4, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of {numel * 4} bytes failed: {err}")
            self.ptr = self.tensor.data_ptr()

    def __del__(self):
        if self.ptr is not None:
            torch.cuda.cudart().cudaHostUnregister(self.ptr)
            self.ptr = None


@dataclasses.dataclass
class AdamWState:
    """The AdamW moments, one f32 tensor per leaf of the params in
    tree_leaves order, and the update count.  With `host` the moments are
    views of one host buffer (init_offload_state), staged on the device
    leaf by leaf at each update."""

    m: List[torch.Tensor]
    v: List[torch.Tensor]
    count: int = 0
    host: Optional["HostMoments"] = None

    def state_dict(self, layout: Optional[list] = None) -> dict:
        """The moments on the host; with `layout` (a Sharding per leaf) each
        gathered whole, leaf by leaf (every rank calls it; the others' lists
        hold None)."""
        if self.host is not None and self.host.cuda:
            torch.cuda.synchronize()  # the staged write-backs are asynchronous
        if layout is None:
            return {"m": [t.detach().cpu() for t in self.m],
                    "v": [t.detach().cpu() for t in self.v], "count": self.count}
        return {"m": [sh.gather_to_host(t) for t, sh in zip(self.m, layout)],
                "v": [sh.gather_to_host(t) for t, sh in zip(self.v, layout)],
                "count": self.count}

    def load_state_dict(self, saved: dict, layout: Optional[list] = None) -> None:
        """Copy saved whole moments in (each cut to this rank's block with
        `layout`)."""
        for i, (dst, src) in enumerate(zip(self.m + self.v, saved["m"] + saved["v"])):
            if layout is not None:
                src = layout[i % len(self.m)].shard(src)
            if dst.shape != src.shape:
                raise ValueError(f"AdamW moment {tuple(src.shape)} does not match "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
        self.count = int(saved["count"])



@dataclasses.dataclass
class TrainState:
    params: Any  # f32 masters with requires_grad (a LoRA state: the adapters)
    opt_state: AdamWState
    step: int = 0
    # sharded: a core/mesh.py Sharding per leaf of params (tree_leaves
    # order), by which checkpoints gather and restore each leaf
    layout: Optional[list] = None


def lr_schedule(tc: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate, as usdm_tpu's make_optimizer builds it with
    optax: warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup + 1))
    or linear_schedule(lr, 0, max(total - warmup, 1), warmup), total =
    tc.max_steps, warmup = max(int(total * warmup_ratio), 1)."""
    total = tc.max_steps
    warmup = max(int(total * tc.warmup_ratio), 1)
    peak = tc.learning_rate
    if tc.lr_schedule == "cosine":
        decay = max(total, warmup + 1) - warmup

        def sched(count: int) -> float:
            if count < warmup:  # linear warmup from 0
                return peak * (count / warmup)
            c = min(count - warmup, decay)
            return peak * 0.5 * (1 + math.cos(math.pi * c / decay))
    else:
        steps = max(total - warmup, 1)

        def sched(count: int) -> float:  # held at lr for `warmup` steps, then to 0
            c = min(max(count - warmup, 0), steps)
            return peak * (1 - c / steps)
    return sched


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def _adamw_leaf(p, g, m, v, scale, lr: float, bc1: float, bc2: float, tc: TrainConfig) -> None:
    """One AdamW update of leaf `p` in place, as optax computes it: the
    gradient times `scale` (the clip), the moments `m`, `v` (b1, b2 of
    `tc`), the update m / bc1 / (sqrt(v / bc2) + eps) plus tc.weight_decay *
    p, then p - lr * update."""
    g = g * scale
    m.mul_(tc.adam_b1).add_(g, alpha=1.0 - tc.adam_b1)
    v.mul_(tc.adam_b2).addcmul_(g, g, value=1.0 - tc.adam_b2)
    upd = (m / bc1).div_((v / bc2).sqrt_().add_(ADAM_EPS)).add_(p, alpha=tc.weight_decay)
    p.add_(upd, alpha=-lr)


class HostMoments:
    """Stages each leaf's moments, held in `buffer`, on the device for its
    update: two staging slots of the largest leaf's size (`largest`
    elements), filled host -> device on one side stream while the previous
    leaf updates, and written back device -> host on another (PCIe carries
    both directions at once).  Without CUDA the same slots are filled and
    drained by plain copies."""

    def __init__(self, buffer: _PinnedBuffer, largest: int, device):
        self.buffer = buffer  # keeps the page-locked memory registered
        self.device = torch.device(device)
        self.slots = [(torch.empty(largest, device=self.device),
                       torch.empty(largest, device=self.device)) for _ in range(2)]
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(self.device)
            self.d2h = torch.cuda.Stream(self.device)

    def run(self, st: AdamWState, fn: Callable[[int, torch.Tensor, torch.Tensor], None]) -> None:
        """fn(i, m_i, v_i) for every leaf i on the current stream, its
        moments staged on the device; each is written back after it."""
        n = len(st.m)
        freed = [None, None]  # the write-back that last read each slot
        compute = torch.cuda.current_stream(self.device) if self.cuda else None
        if self.cuda:
            self.h2d.wait_stream(self.d2h)  # the last step's write-backs land first

        def fetch(i):
            slot = self.slots[i % 2]
            m, v = (buf[:st.m[i].numel()].view(st.m[i].shape) for buf in slot)
            if not self.cuda:
                m.copy_(st.m[i])
                v.copy_(st.v[i])
                return m, v, None
            with torch.cuda.stream(self.h2d):
                if freed[i % 2] is not None:
                    self.h2d.wait_event(freed[i % 2])
                m.copy_(st.m[i], non_blocking=True)
                v.copy_(st.v[i], non_blocking=True)
                return m, v, self.h2d.record_event()

        staged = fetch(0)
        for i in range(n):
            m, v, ready = staged
            if ready is not None:
                compute.wait_event(ready)
            if i + 1 < n:
                staged = fetch(i + 1)
            fn(i, m, v)
            if not self.cuda:
                st.m[i].copy_(m)
                st.v[i].copy_(v)
                continue
            done = compute.record_event()
            with torch.cuda.stream(self.d2h):
                self.d2h.wait_event(done)
                st.m[i].copy_(m, non_blocking=True)
                st.v[i].copy_(v, non_blocking=True)
                freed[i % 2] = self.d2h.record_event()
        if self.cuda:
            compute.wait_stream(self.d2h)


@torch.no_grad()
def manual_adamw_update(leaves: List[torch.Tensor], grads: List[torch.Tensor], st: AdamWState,
                        sched: Callable[[int], float], tc: TrainConfig,
                        clip: bool = True,
                        gnorm: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """One clipped AdamW step over `leaves` in place, leaf by leaf, as
    usdm_tpu's manual_adamw_update (and its make_optimizer) computes it:
    g * min(1, clip / max(norm, 1e-12)), the moments, the bias-corrected
    update plus weight decay, p - lr * update, lr = sched(count before the
    increment).  Moments on the host (`st.host`) are staged leaf by leaf.
    Each gradient is released after its leaf.  `clip` False: optax's plain
    adamw, the gradients unscaled.  `gnorm`: the global norm, computed by
    the caller (a sharded state's, sharded_global_norm).
    -> the global norm of the unclipped gradients (None without `clip`)."""
    if clip and gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0) if clip
             else 1.0)
    lr = sched(st.count)
    c1 = st.count + 1
    bc1, bc2 = 1.0 - tc.adam_b1 ** c1, 1.0 - tc.adam_b2 ** c1

    def update(i, m, v):
        _adamw_leaf(leaves[i], grads[i], m, v, scale, lr, bc1, bc2, tc)
        grads[i] = None

    if st.host is None:
        for i in range(len(leaves)):
            update(i, st.m[i], st.v[i])
    else:
        st.host.run(st, update)
    st.count = c1
    return gnorm


class ClipAdamW:
    """make_optimizer's transformation: optax.chain(clip_by_global_norm,
    adamw(schedule)) over a params tree, updating it in place from the
    gradients its leaves hold in `.grad` (which it clears; a leaf without
    one takes a zero gradient).  `schedule` (count -> lr) defaults to
    lr_schedule(tc); `clip` False leaves out the clipping (the GAN
    trainer's optax.adamw)."""

    def __init__(self, tc: TrainConfig, schedule: Optional[Callable[[int], float]] = None,
                 clip: bool = True):
        self.tc, self.clip = tc, clip
        self.schedule = schedule or lr_schedule(tc)

    def init(self, params, host: bool = False) -> AdamWState:
        """Zero moments beside each leaf, or (`host`) in one host buffer,
        page-locked when the leaves are on the card."""
        leaves = tree_leaves(params)
        if not host:
            return AdamWState([torch.zeros_like(p, dtype=torch.float32) for p in leaves],
                              [torch.zeros_like(p, dtype=torch.float32) for p in leaves], 0)
        sizes = [p.numel() for p in leaves]
        buf = _PinnedBuffer(2 * sum(sizes), pin=leaves[0].is_cuda)
        views = [t.view(p.shape) for t, p in
                 zip(buf.tensor.split(sizes + sizes), leaves + leaves)]
        return AdamWState(views[:len(leaves)], views[len(leaves):], 0,
                          HostMoments(buf, max(sizes), leaves[0].device))

    def update(self, params, st: AdamWState, layout: Optional[list] = None):
        """`layout` (a sharded state's Sharding per leaf): the gradients are
        first completed over the mesh (sync_sharded_grads) and the clip
        norm is the global one."""
        leaves = tree_leaves(params)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        gnorm = None
        if layout is not None:
            sync_sharded_grads(grads, layout)
            gnorm = sharded_global_norm(grads, layout) if self.clip else None
        return manual_adamw_update(leaves, grads, st, self.schedule, self.tc, self.clip, gnorm)


@torch.no_grad()
def sync_sharded_grads(grads: List[torch.Tensor], layout: list) -> None:
    """Complete a sharded step's gradients in place.  A leaf split over data
    has its sum already (its gather's backward reduce-scattered it); the
    leaves replicated over data (the norms) are all-reduced over data, in
    one call; on a multi-slice mesh every gradient is then all-reduced over
    replica, in one call.  Model ranks hold whole, equal gradients of the
    replicated leaves: the backward all-reduced their inputs' gradients."""
    mesh = layout[0].mesh
    MS.all_reduce_coalesced([g for g, sh in zip(grads, layout) if MS.DATA_AXIS not in sh.spec],
                            mesh, (MS.DATA_AXIS,))
    if MS.REPLICA_AXIS in mesh.axis_names:
        MS.all_reduce_coalesced(grads, mesh, (MS.REPLICA_AXIS,))


@torch.no_grad()
def sharded_global_norm(grads: List[torch.Tensor], layout: list) -> torch.Tensor:
    """The global norm of a sharded state's gradients: each leaf's squared
    norm summed over every rank in one all-reduce, a leaf replicated over
    an axis counted only at coordinate 0 there, then global_norm's
    reduction over the leaves' norms.  sqrt(n * n) == n in binary floating
    point, so a one-rank mesh gives global_norm's bits."""
    mesh = layout[0].mesh
    norms = torch.stack(torch._foreach_norm(grads))
    once = torch.tensor([float(all(mesh.coord(a) == 0 for a in sh.replicated_axes))
                         for sh in layout], device=norms.device)
    sq = MS.all_reduce(norms * norms * once, mesh, None)
    return torch.linalg.vector_norm(torch.sqrt(sq))


def make_optimizer(tc: TrainConfig) -> ClipAdamW:
    return ClipAdamW(tc)


def batch_spec(mesh: Optional["MS.Mesh"] = None) -> Dict[str, tuple]:
    """Batch rows split over `data`, over (replica, data) on a multi-slice
    mesh (usdm_tpu's batch_spec): each slice takes a block of rows, so the
    only collective across slices is the per-step gradient all-reduce."""
    axes = mesh.batch_axes if mesh is not None else (MS.DATA_AXIS,)
    spec = (axes if len(axes) > 1 else axes[0], None)
    return {"input_ids": spec, "labels": spec, "segment_ids": spec, "positions": spec}


def state_specs(cfg: MistralConfig) -> TrainState:
    """The placement of every leaf of a TrainState: the params' specs, the
    moments' the same leaf by leaf, the count and step replicated."""
    pspecs = M.param_specs(cfg)
    leaves = [s for lp in pspecs["layers"] for s in lp.values()]
    flat = [pspecs["embed"], *leaves, pspecs["final_norm"], pspecs["lm_head"]]
    return TrainState(pspecs, AdamWState(list(flat), list(flat), 0), 0)


def offload_state_specs(cfg: MistralConfig) -> TrainState:
    """state_specs of the offloaded state: the same blocks, each rank's
    moments in its own pinned host buffer (usdm_tpu's pinned_host memory
    kind)."""
    return state_specs(cfg)


def shard_params(params, cfg: MistralConfig, mesh: "MS.Mesh"):
    """Whole params -> this rank's blocks (param_shardings; the vocab padded
    to a multiple of tp), each a new tensor on the mesh's device."""
    return tree_map2(lambda t, sh: sh.shard(t.detach().to(mesh.device)), params,
                     M.param_shardings(cfg, mesh))


def _init(cfg: MistralConfig, tc: TrainConfig, device, generator, params, host: bool,
          mesh: Optional["MS.Mesh"]):
    layout = None
    if mesh is not None:
        shs = M.param_shardings(cfg, mesh)
        if params is None:
            params = M.init_params(cfg, generator, device, dtype="float32", shardings=shs)
        else:
            params = shard_params(params, cfg, mesh)
        layout = tree_leaves(tree_map2(lambda t, sh: sh, params, shs))
    elif params is None:
        params = M.init_params(cfg, generator, device, dtype="float32")
    params = tree_map(lambda a: a.detach().to(device, torch.float32).requires_grad_(True),
                      params)
    return TrainState(params, ClipAdamW(tc).init(params, host=host), 0, layout)


def init_state(cfg: MistralConfig, tc: TrainConfig, device, generator=None,
               params=None, mesh: Optional["MS.Mesh"] = None) -> TrainState:
    """f32 masters on `device` (`params`, or drawn there from `generator`)
    with zero moments beside them.  `mesh`: this rank's blocks only (a
    drawn leaf is cut as soon as it exists; `params`, whole, are cut)."""
    return _init(cfg, tc, device, generator, params, False, mesh)


def init_offload_state(cfg: MistralConfig, tc: TrainConfig, device, generator=None,
                       params=None, mesh: Optional["MS.Mesh"] = None) -> TrainState:
    """init_state with the moments in pinned host memory (usdm_tpu's
    pinned_host memory kind), streamed through the device by the step;
    with a `mesh`, each rank's buffer holds its blocks.  Needed for the
    full-width 7B on one 80 GB card: its f32 moments alone are 54.6 GiB
    (memory_budget)."""
    return _init(cfg, tc, device, generator, params, True, mesh)


def load_masters(path: str, device) -> tuple:
    """An HF Mistral dir -> (f32 master params on `device`, its config with
    the trainers' compute dtype)."""
    from usdm_tpu_torch.core import checkpoint as ckpt

    params, cfg = ckpt.load_mistral(path, dtype="float32", device=device)
    return params, cfg.replace(dtype=COMPUTE_DTYPE)


def _loss(params, cfg: MistralConfig, tc: TrainConfig, batch, remat: bool, mesh=None):
    return M.loss_fn(params, cfg, batch["input_ids"], batch["labels"],
                     batch.get("segment_ids"), batch.get("positions"), remat=remat,
                     ce_chunk=tc.ce_chunk, mesh=mesh)


def make_train_step(cfg: MistralConfig, tc: TrainConfig, mesh: Optional["MS.Mesh"] = None):
    """-> step(state, batch) -> {"loss", "grad_norm", "ntokens"} (device
    tensors, no synchronization); the state updated in place, its moments
    resident (init_state) or streamed from and back to host memory
    (init_offload_state).  batch: input_ids, labels and optional
    segment_ids, positions [B, T] on the params' device.  Computes in
    cfg.dtype.  `mesh`: the state is init_state(..., mesh=)'s and the batch
    this rank's rows (core/mesh.py shard_batch); the metrics are global."""
    opt = make_optimizer(tc)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, aux = _loss(state.params, cfg, tc, batch, tc.remat, mesh)
        loss.backward()
        gnorm = opt.update(state.params, state.opt_state, state.layout)
        state.step += 1
        return {"loss": aux["loss"], "grad_norm": gnorm, "ntokens": aux["ntokens"]}

    return step


def make_eval_step(cfg: MistralConfig, tc: TrainConfig, mesh: Optional["MS.Mesh"] = None):
    """-> step(params, batch) -> {"loss", "ntokens"}: no gradient, no
    remat (`mesh`: as make_train_step's)."""

    @torch.no_grad()
    def step(params, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, aux = _loss(params, cfg, tc, batch, False, mesh)
        return {"loss": aux["loss"], "ntokens": aux["ntokens"]}

    return step


def step_collectives(cfg: MistralConfig, tc: TrainConfig, seq_len: int,
                     axes: Sequence[str] = (MS.DATA_AXIS, MS.MODEL_AXIS)) -> Dict[str, int]:
    """The collectives one sharded make_train_step step runs, by core/mesh.py
    counter name, for L = cfg.num_layers and rows of `seq_len` tokens:

      * all_gather:data   2 (embed, lm_head) + 7 a layer, twice with remat
                          (the recompute gathers again);
      * reduce_scatter:data  2 + 7 L, one per split weight's gradient;
      * all_gather:model  one per CE chunk, twice when chunked (the chunk's
                          recompute);
      * all_reduce:model  the embedding's rows, wo's and w_down's sums in
                          forward (2 L); in the remat recompute only wo's
                          (L): non-reentrant checkpoint stops recomputing
                          after the last saved tensor, w_down's product;
                          in backward one a column-split input (2 L) and
                          lm_head's input: 2 + 5 L with remat, 2 + 4 L without;
      * all_reduce:data   the token count, the shown loss, the norms'
                          gradients: 3 (and on replica the same 3, the
                          gradients in one call);
      * all_reduce:world  the clip norm's squared shard norms: 1."""
    L, t1 = cfg.num_layers, seq_len - 1
    chunks = 1 if not tc.ce_chunk or t1 <= tc.ce_chunk else -(-t1 // tc.ce_chunk)
    remat = 2 if tc.remat else 1
    out = {"all_gather:data": 2 + 7 * L * remat, "reduce_scatter:data": 2 + 7 * L,
           "all_gather:model": chunks * (2 if chunks > 1 else 1),
           "all_reduce:model": 2 + (5 if tc.remat else 4) * L,
           "all_reduce:data": 3, "all_reduce:world": 1}
    if MS.REPLICA_AXIS in axes:
        out["all_reduce:replica"] = 3
    return out


def _param_shapes(cfg: MistralConfig) -> list:
    """usdm_tpu's stacked param leaves as (shape, partition spec, per-layer
    leading dims): the port keeps one tensor per layer, [L, ...] -> [...]."""
    d, f, v, L = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_layers
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    dm, md = (None, "data", "model"), (None, "model", "data")
    return [((v, d), ("model", "data"), False), ((L, d), (None, None), True),
            ((L, d), (None, None), True), ((L, d, q), dm, True), ((L, d, kv), dm, True),
            ((L, d, kv), dm, True), ((L, q, d), md, True), ((L, d, f), dm, True),
            ((L, d, f), dm, True), ((L, f, d), md, True), ((d,), (None,), False),
            ((d, v), ("data", "model"), False)]


def memory_budget(cfg: MistralConfig, dp: int = 8, tp: int = 1, seq_len: int = 8192,
                  batch_per_chip: int = 1, offload: bool = False, hbm_gb: float = 16.0,
                  ce_chunk: int = 1024) -> Dict[str, float]:
    """Per-device training memory arithmetic (GiB), usdm_tpu's keys and
    terms: f32 masters and grads, Adam's two moments (on the host with
    `offload`), the bf16 compute copy (usdm_tpu casts the whole tree; the
    port casts one layer at a time, so its real peak stays below this),
    one bf16 hidden per layer kept by remat, ~12 bytes per logit of one
    ce_chunk through forward and backward.  `streamed_gb` is the offload
    step's staging of the port's largest leaf (per-layer leaves, at most
    the [vocab, hidden] embedding), where usdm_tpu streams its stacked
    [L, ...] leaves; update_peak_gb, device_gb and fits follow from it.
    `hbm_gb` is the device's memory (the CLIs read the card's)."""
    axis = {"data": dp, "model": tp, None: 1}
    gb = 1 / (1 << 30)
    shard, leaf = [], []
    for shape, spec, stacked in _param_shapes(cfg):
        factor = math.prod(axis[a] for a in spec)
        shard.append(math.prod(shape) * 4 // factor)
        leaf.append(math.prod(shape[1:] if stacked else shape) * 4 // factor)
    masters = sum(shard) * gb
    grads = masters
    moments = 2.0 * masters
    bf16_copy = masters / 2.0
    acts = cfg.num_layers * batch_per_chip * seq_len * cfg.hidden_size * 2 * gb
    logits_tokens = min(seq_len, ce_chunk) if ce_chunk else seq_len
    logits = batch_per_chip * logits_tokens * cfg.vocab_size * 12 * gb
    streamed = 3 * max(leaf) * gb if offload else 0.0
    resident = masters + (0.0 if offload else moments)
    fwd_bwd_peak = resident + bf16_copy + acts + logits + grads
    update_peak = resident + grads + streamed
    device = max(fwd_bwd_peak, update_peak)
    return {
        "masters_gb": masters, "grads_gb": grads, "moments_gb": moments,
        "bf16_copy_gb": bf16_copy, "activations_gb": acts, "logits_gb": logits,
        "streamed_gb": streamed, "fwd_bwd_peak_gb": fwd_bwd_peak,
        "update_peak_gb": update_peak, "device_gb": device,
        "host_gb": moments if offload else 0.0, "hbm_gb": hbm_gb,
        "fits": device <= 0.9 * hbm_gb,  # 10% allocator slack
    }
