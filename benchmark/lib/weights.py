"""Seeded Mistral weights, made on the device in one generator call per
layer (and one for the embedding, final norm and head), in the layouts the
port serves and trains: projections [Din, Dout], embed and lm_head [V, D].
Any one layer can be made again alone from the seed, which is how the
plain reference gets the same numbers without reading the program's."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.lib.counts import dims

NORM_STD = 0.1  # norms 1 + N(0, 0.1^2), so a norm weight that is ignored shows


def _seed(seed: int, idx: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * idx + 17) % (1 << 62)


def layer_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    g = dims(cfg)
    q, kv = g["H"] * g["d"], g["Hkv"] * g["d"]
    return [("ln1", (g["D"],)), ("ln2", (g["D"],)), ("wq", (g["D"], q)), ("wk", (g["D"], kv)),
            ("wv", (g["D"], kv)), ("wo", (q, g["D"])), ("w_gate", (g["D"], g["F"])),
            ("w_up", (g["D"], g["F"])), ("w_down", (g["F"], g["D"]))]


def _carve(flat: torch.Tensor, shapes, std: float) -> Dict[str, torch.Tensor]:
    out, o = {}, 0
    for name, shape in shapes:
        n = 1
        for s in shape:
            n *= s
        t = flat[o:o + n].view(shape)
        if name.startswith("ln") or name == "final_norm":
            # a copy: a layer's buffer must not outlive its projections
            # (the program replaces them by their W8A8 copies)
            t = t.mul_(NORM_STD).add_(1.0).clone()
        else:
            t.mul_(std)
        out[name] = t
        o += n
    return out


def _draw(n: int, seed: int, idx: int, device, dtype) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(_seed(seed, idx))
    return torch.randn(n, generator=g, device=device, dtype=dtype)


def make_layer(cfg: dict, seed: int, i: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Layer i's weights: views of one buffer drawn in one call."""
    shapes = layer_shapes(cfg)
    n = sum(torch.Size(s).numel() for _, s in shapes)
    return _carve(_draw(n, seed, i + 1, device, dtype), shapes, cfg["initializer_range"])


def make_outer(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """embed [V, D], final_norm [D], lm_head [V, D] from one call."""
    g = dims(cfg)
    shapes = [("embed", (g["V"], g["D"])), ("final_norm", (g["D"],)),
              ("lm_head", (g["V"], g["D"]))]
    n = sum(torch.Size(s).numel() for _, s in shapes)
    return _carve(_draw(n, seed, 0, device, dtype), shapes, cfg["initializer_range"])


def make_params(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The whole model as the port's param tree."""
    outer = make_outer(cfg, seed, device, dtype)
    return {"embed": outer["embed"],
            "layers": [make_layer(cfg, seed, i, device, dtype)
                       for i in range(cfg["num_hidden_layers"])],
            "final_norm": outer["final_norm"], "lm_head": outer["lm_head"]}


def make_lora(cfg: dict, seed: int, r: int, alpha: float, targets: Dict[str, tuple],
              b_std: float, device) -> List[dict]:
    """LoRA adapters of a fine-tune under way: A ~ N(0, 1/r), B ~ N(0,
    b_std^2) (not 0, so every adapter leaf takes a gradient from the first
    step), scale alpha / r; f32, one call for all layers."""
    per = sum(din * r + r * dout for din, dout in targets.values())
    flat = _draw(per * cfg["num_hidden_layers"], seed, 10_000, device, torch.float32)
    out, o = [], 0
    for _ in range(cfg["num_hidden_layers"]):
        layer = {}
        for name, (din, dout) in targets.items():
            a = flat[o:o + din * r].view(din, r).mul_(r ** -0.5)
            o += din * r
            b = flat[o:o + r * dout].view(r, dout).mul_(b_std)
            o += r * dout
            layer[name] = {"a": a, "b": b,
                           "scale": torch.tensor(alpha / r, device=device, dtype=torch.float32)}
        out.append(layer)
    return out
