"""Plain PyTorch Mistral: the yardstick that decides `correct`.

Imports nothing of the program: the weights are made again from the seed by
the benchmark's own maker (benchmark/lib/weights.py), one layer at a time,
and every derived quantity (int8 or int4 weights and their scales, the
int8 keys and values, the optimizer's moments) is worked out here from the
published equations:

  RMSNorm (eps from the config), HF-convention RoPE, grouped-query
  attention with a causal sliding window (a query at position p sees keys
  at p - window .. p), SiLU-gated MLP, an untied lm_head.

Two uses:

* `serve_logits`: the served LM as configured (W8A8: each projection's
  weight symmetric int8 per output channel over its inputs, scale
  max(amax / 127, 1e-8) kept in bf16; each activation row symmetric int8;
  keys and values int8 per token and kv head), computed in f32 with TF32
  off, over whole sequences (prompt plus served tokens) with no cache;
  `weight_bits=4` is the control, the same with int4 weights.
* `train_readings`: the first two steps of a bf16 training step over f32
  masters (full or LoRA, clipped AdamW with the trainer's schedule),
  computed layer by layer with recomputation so that no whole-model
  gradient is ever held: -> each step's loss, every leaf's first gradient
  as the optimizer gets it (clipped), and every leaf's change after step 2.
  `precision="fp8"` is the control (every product's operands rounded to
  float8 e4m3 with a per-tensor scale); `half_batch` leaves out the second
  half of each row's labels (a fault: the mean taken over the rest).
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from benchmark.lib.weights import make_layer, make_lora, make_outer


@contextmanager
def no_tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


# ------------------------------------------------------------------ pieces
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """In f32, cast back to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps) * w.float()).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, H, d], pos [T] -> rotated (rotate_half convention), in x's dtype."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, device=x.device, dtype=torch.float64) / d))
    ang = pos.double()[:, None] * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1).float()[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1).float()[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return (x.float() * cos + rot.float() * sin).to(x.dtype)


def attention(q, k, v, window: int) -> torch.Tensor:
    """One document: q [T, H, d], k/v [T, Hkv, d], causal from its first
    token, windowed; scores and softmax in f32 -> [T, H * d] in q's dtype."""
    t, h, d = q.shape
    rep = h // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("qhd,khd->hqk", q.float(), kf) / math.sqrt(d)
    i = torch.arange(t, device=q.device)
    rel = i[:, None] - i[None, :]
    s = s.masked_fill(~((rel >= 0) & (rel <= window)), float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), vf)
    return o.reshape(t, h * d).to(q.dtype)


def sym_quant(x: torch.Tensor, bits: int, dim: int):
    """Symmetric round-half-even quantization over `dim` -> (integers as
    f32, f32 scale with `dim` kept)."""
    top = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().amax(dim=dim, keepdim=True) / top, min=1e-8)
    return torch.clamp(torch.round(x / scale), -top, top), scale


def quant_weight(w: torch.Tensor, bits: int):
    """w [Din, Dout] -> (integer values [Din, Dout] f32, per-output scale
    [Dout] as bf16 keeps it, back in f32)."""
    q, s = sym_quant(w.float(), bits, dim=0)
    return q, s[0].to(torch.bfloat16).float()


def wxa8(y: torch.Tensor, qw) -> torch.Tensor:
    """y [T, Din] f32 through a quantized weight: rows to int8, the integer
    product (f32, TF32 off), then row scale times channel scale."""
    qy, ys = sym_quant(y, 8, dim=-1)
    return (qy @ qw[0]) * ys * qw[1]


def kv_int8(x: torch.Tensor) -> torch.Tensor:
    """Keys or values [T, Hkv, d] through an int8 cache: per token and kv
    head, over d."""
    q, s = sym_quant(x, 8, dim=-1)
    return q * s


# ------------------------------------------------------------------ serving
@torch.no_grad()
def serve_logits(cfg: dict, seed: int, seqs: Sequence[Sequence[int]],
                 starts: Sequence[int], device, weight_bits: int = 8) -> List[torch.Tensor]:
    """Logits [len(seq) - start, V] f32 predicting seq[start:], for each
    whole sequence (prompt and served tokens), through the served LM."""
    D, eps, theta = cfg["hidden_size"], cfg["rms_norm_eps"], cfg["rope_theta"]
    H, Hkv, d, W = (cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
                    cfg["sliding_window"])
    with no_tf32():
        outer = make_outer(cfg, seed, device)
        xs = [outer["embed"][torch.tensor(list(s), device=device)].float() for s in seqs]
        for i in range(cfg["num_hidden_layers"]):
            lw = make_layer(cfg, seed, i, device)
            qw = {k: quant_weight(lw[k], weight_bits)
                  for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}
            del lw["wq"], lw["wk"], lw["wv"], lw["wo"], lw["w_gate"], lw["w_up"], lw["w_down"]
            for j, x in enumerate(xs):
                t = x.shape[0]
                pos = torch.arange(t, device=device)
                y = rms_norm(x, lw["ln1"], eps)
                q = rope(wxa8(y, qw["wq"]).view(t, H, d), pos, theta)
                k = rope(wxa8(y, qw["wk"]).view(t, Hkv, d), pos, theta)
                k, v = kv_int8(k), kv_int8(wxa8(y, qw["wv"]).view(t, Hkv, d))
                x = x + wxa8(attention(q, k, v, W), qw["wo"])
                y = rms_norm(x, lw["ln2"], eps)
                x = x + wxa8(F.silu(wxa8(y, qw["w_gate"])) * wxa8(y, qw["w_up"]), qw["w_down"])
                xs[j] = x
            del qw, lw
        head = outer["lm_head"].float()
        out = []
        for x, st in zip(xs, starts):
            h = rms_norm(x[st - 1:-1], outer["final_norm"], eps)
            out.append(h @ head.t())
        return out


def served_gap(logits: torch.Tensor, served: Sequence[int], allow: torch.Tensor) -> float:
    """The widest gap by which a served token's logit lies below the
    reference's best allowed logit, over every served position."""
    lg = logits.masked_fill(~allow[None], float("-inf"))
    best = lg.max(-1).values
    got = lg.gather(-1, torch.tensor(list(served), device=lg.device)[:, None])[:, 0]
    return float((best - got).max())


def control_gap(ref: torch.Tensor, low: torch.Tensor, allow: torch.Tensor) -> float:
    """The control's reading: at each position the token the lower
    precision puts first, its gap below the reference's best."""
    lg = ref.masked_fill(~allow[None], float("-inf"))
    pick = low.masked_fill(~allow[None], float("-inf")).argmax(-1)
    return float((lg.max(-1).values - lg.gather(-1, pick[:, None])[:, 0]).max())


# ------------------------------------------------------------------ training
def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x through float8 e4m3 with a per-tensor scale, the gradient passed
    straight through."""
    s = torch.clamp(x.detach().abs().amax().float() / 448.0, min=1e-12)
    r = (x.detach().float() / s).to(torch.float8_e4m3fn).float().mul(s).to(x.dtype)
    return x + (r - x).detach()


class _Mm:
    def __init__(self, precision: str):
        self.fp8 = precision == "fp8"

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            a, b = fp8_round(a), fp8_round(b)
        return a @ b


def _layer_train(cfg, x, w, lw, seg_slices, pos, mm: _Mm):
    """One decoder layer in bf16 over f32 masters `w` (cast here), LoRA
    adapters `lw` (f32, cast) or None; documents attend to themselves."""
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    H, Hkv, d, W = (cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
                    cfg["sliding_window"])
    bf = torch.bfloat16
    wb = {k: v.to(bf) for k, v in w.items() if v.ndim == 2}

    def proj(y, name):
        out = mm(y, wb[name])
        if lw is not None and name in lw:
            a = lw[name]
            out = out + mm(mm(y, a["a"].to(bf)), a["b"].to(bf)) * a["scale"].to(bf)
        return out

    t = x.shape[0]
    y = rms_norm(x, w["ln1"], eps)
    q = rope(proj(y, "wq").view(t, H, d), pos, theta)
    k = rope(proj(y, "wk").view(t, Hkv, d), pos, theta)
    v = proj(y, "wv").view(t, Hkv, d)
    att = torch.cat([attention(q[a:b], k[a:b], v[a:b], W) for a, b in seg_slices])
    x = x + proj(att, "wo")
    y = rms_norm(x, w["ln2"], eps)
    return x + mm(F.silu(mm(y, wb["w_gate"])) * mm(y, wb["w_up"]), wb["w_down"])


def _row(batch: Dict[str, torch.Tensor], half_batch: bool):
    ids = batch["input_ids"][0].long()
    labels = batch["labels"][0].long().clone()
    if half_batch:
        labels[labels.shape[0] // 2:] = -100
    seg = batch["segment_ids"][0]
    pos = batch["positions"][0]
    cut = (torch.nonzero(seg[1:] != seg[:-1])[:, 0] + 1).tolist()
    edges = [0] + cut + [seg.shape[0]]
    return ids, labels, pos, list(zip(edges[:-1], edges[1:]))


def _grads_rows(cfg, seed, batches, device, mm, lora, half_batch, master_dtype, on_grads):
    """Losses and gradients of several rows in lockstep, layer by layer:
    forward storing each layer's input (bf16) per row, the head's
    gradients, then each layer made again and recomputed under autograd
    from each row's input, last to first.  `on_grads({leaf: [grad of each
    row]})` receives each group of leaves (full training: the masters;
    LoRA: one layer's adapters) -> the losses."""
    L = cfg["num_hidden_layers"]
    rows = [_row(b, half_batch) for b in batches]
    bf = torch.bfloat16
    outer = make_outer(cfg, seed, device, master_dtype)
    full = lora is None
    inputs = [[] for _ in rows]
    xs = []
    with torch.no_grad():
        for r, (ids, _, pos, slices) in enumerate(rows):
            xs.append(F.embedding(ids, outer["embed"]).to(bf))
        for i in range(L):
            w = make_layer(cfg, seed, i, device, master_dtype)
            for r, (_, _, pos, slices) in enumerate(rows):
                inputs[r].append(xs[r])
                xs[r] = _layer_train(cfg, xs[r], w, None if full else lora[i], slices, pos, mm)
            del w
    fn = outer["final_norm"].detach().requires_grad_(full)
    head = outer["lm_head"].detach().requires_grad_(full)
    losses, gs, head_grads = [], [], {"final_norm": [], "lm_head": []}
    for r, (ids, labels, pos, slices) in enumerate(rows):
        xh = xs[r].detach().requires_grad_(True)
        h = rms_norm(xh, fn, cfg["rms_norm_eps"])[:-1]
        tgt = labels[1:]
        valid = tgt != -100
        logits = mm(h, head.to(bf).t()).float()
        ll = torch.log_softmax(logits, -1).gather(-1, torch.where(valid, tgt, 0)[:, None])[:, 0]
        loss = -(ll * valid).sum() / valid.sum().clamp(min=1)
        wrt = [xh, fn, head] if full else [xh]
        got = torch.autograd.grad(loss, wrt)
        losses.append(float(loss.detach()))
        gs.append(got[0])
        if full:
            head_grads["final_norm"].append(got[1])
            head_grads["lm_head"].append(got[2])
        del logits, ll, h, loss, got
    xs = None
    if full:
        on_grads(head_grads)
    for i in reversed(range(L)):
        w = {k: v.detach().requires_grad_(full)
             for k, v in make_layer(cfg, seed, i, device, master_dtype).items()}
        lw = None if full else lora[i]
        ad = [] if full else [lw[t][p] for t in lw for p in ("a", "b", "scale")]
        group = {}
        for r, (ids, _, pos, slices) in enumerate(rows):
            xi = inputs[r][i].detach().requires_grad_(True)
            out = _layer_train(cfg, xi, w, lw, slices, pos, mm)
            wrt = [xi] + (list(w.values()) if full else ad)
            got = torch.autograd.grad(out, wrt, gs[r])
            gs[r] = got[0]
            names = (list(w) if full else
                     [f"lora.{i}.{t}.{p}" for t in lw for p in ("a", "b", "scale")])
            for n, g in zip(names, got[1:]):
                group.setdefault(n if not full else f"layers.{i}.{n}", []).append(g)
            inputs[r][i] = None
            del out, got
        on_grads(group)
        del w, group
    if full:
        ge = []
        for r, (ids, _, _, _) in enumerate(rows):
            e = torch.zeros_like(outer["embed"])
            e.index_add_(0, ids, gs[r].float())
            ge.append(e)
        on_grads({"embed": ge})
    return losses


def _leaf_order(cfg, lora_targets) -> List[str]:
    """Leaf names in the trainer's order (tree_leaves of its params)."""
    keys = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    L = cfg["num_hidden_layers"]
    if lora_targets is None:
        return (["embed"] + [f"layers.{i}.{k}" for i in range(L) for k in keys]
                + ["final_norm", "lm_head"])
    return [f"lora.{i}.{t}.{p}" for i in range(L) for t in lora_targets
            for p in ("a", "b", "scale")]


def train_readings(cfg: dict, seed: int, batches: List[Dict[str, torch.Tensor]], device,
                   opt: dict, lora: Optional[dict] = None, precision: str = "bf16",
                   half_batch: bool = False) -> dict:
    """Steps 1 and 2 of the trainer from the seed's weights on `batches[0]`
    and `batches[1]` (step 1's learning rate is the schedule's at count 0).
    `opt`: lr, warmup, total, b1, b2, eps, wd, clip (the trainer's clipped
    AdamW and warmup-cosine schedule).  `lora`: {"r", "alpha", "targets":
    {name: (din, dout)}, "b_std"}.  -> {"losses": [l1, l2], "grad": {leaf:
    norm of step 1's clipped gradient}, "change": {leaf: norm of the leaf's
    change after step 2}}."""
    mm = _Mm(precision)
    master = torch.float32
    rows = batches[:2]
    if lora is not None:
        adapters = make_lora(cfg, seed, lora["r"], lora["alpha"], lora["targets"],
                             lora["b_std"], device)
        for t in tree_adapters(adapters):
            t.requires_grad_(True)
        grads = {}
        losses = _grads_rows(cfg, seed, rows, device, mm, adapters, half_batch, master,
                             grads.update)
        names = _leaf_order(cfg, list(lora["targets"]))
        values = {f"lora.{i}.{t}.{p}": a[t][p] for i, a in enumerate(adapters)
                  for t in a for p in ("a", "b", "scale")}
        sq = [sum(float(grads[n][r].double().pow(2).sum()) for n in names) for r in (0, 1)]
        step = _Adam(opt, sq)
        out_g, out_c = {}, {}
        for n in names:
            out_g[n], out_c[n] = step(grads[n][0], grads[n][1], values[n].detach().float())
        return {"losses": losses, "grad": out_g, "change": out_c}

    # full training: one pass for the clip norms, a second for the updates
    sq = [0.0, 0.0]

    def acc(group):
        for gl in group.values():
            for r, g in enumerate(gl):
                sq[r] += float(g.double().pow(2).sum())

    losses = _grads_rows(cfg, seed, rows, device, mm, None, half_batch, master, acc)
    step = _Adam(opt, sq)
    out_g, out_c = {}, {}

    def finish(group):
        for n, (g1, g2) in group.items():
            out_g[n], out_c[n] = step(g1, g2, _master_leaf(cfg, seed, n, device, master))

    _grads_rows(cfg, seed, rows, device, mm, None, half_batch, master, finish)
    names = _leaf_order(cfg, None)
    return {"losses": losses, "grad": {n: out_g[n] for n in names},
            "change": {n: out_c[n] for n in names}}


def tree_adapters(adapters):
    return [a[t][p] for a in adapters for t in a for p in ("a", "b", "scale")]


class _Adam:
    """Steps 1 and 2 of the trainer's clipped AdamW on one leaf: step 1 at
    the schedule's count 0 (moments only when its rate is 0), step 2 at
    count 1.  `sq`: each row's squared global gradient norm (the clip)."""

    def __init__(self, opt: dict, sq: List[float]):
        self.o = opt
        self.scales = [min(1.0, opt["clip"] / max(math.sqrt(s), 1e-12)) for s in sq]
        warm, total, peak = opt["warmup"], opt["total"], opt["lr"]

        def sched(count):
            if count < warm:
                return peak * count / warm
            decay = max(total, warm + 1) - warm
            return peak * 0.5 * (1 + math.cos(math.pi * min(count - warm, decay) / decay))

        self.lrs = [sched(0), sched(1)]

    def __call__(self, g1, g2, p):
        """-> (norm of step 1's clipped gradient, norm of the change)."""
        o = self.o
        g1, g2 = g1.float() * self.scales[0], g2.float() * self.scales[1]
        m = (1 - o["b1"]) * g1
        v = (1 - o["b2"]) * g1 * g1
        p0 = p
        upd = (m / (1 - o["b1"])) / ((v / (1 - o["b2"])).sqrt() + o["eps"]) + o["wd"] * p
        p = p - self.lrs[0] * upd
        m = o["b1"] * m + (1 - o["b1"]) * g2
        v = o["b2"] * v + (1 - o["b2"]) * g2 * g2
        upd = (m / (1 - o["b1"] ** 2)) / ((v / (1 - o["b2"] ** 2)).sqrt() + o["eps"]) + o["wd"] * p
        p = p - self.lrs[1] * upd
        return float(g1.double().norm()), float((p.double() - p0.double()).norm())


def _master_leaf(cfg, seed, name, device, dtype):
    if name.startswith("layers."):
        _, i, k = name.split(".")
        return make_layer(cfg, seed, int(i), device, dtype)[k]
    return make_outer(cfg, seed, device, dtype)[name]
