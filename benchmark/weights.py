"""Random weights made on the card from the run's seed, in one draw: every
parameter of a network a slice of one uniform [-1, 1) vector scaled to the
published initializer's range (xavier for the embedding tables, 1 /
sqrt(fan_in) for dense layers and their biases, sqrt(6 / 2D) for the GCN
weight), BatchNorm scales and shifts near 1 and 0. Biases and BatchNorm
parameters are drawn too, so that a step that ignored one would show."""

from __future__ import annotations

import math

import numpy as np
import torch


def _scale(name: str, shape, shapes: dict) -> tuple[float, float]:
    """(offset, half-width) of leaf `name`'s uniform range."""
    if name.startswith("batch_norms."):
        return (1.0, 0.1) if name.endswith("weight") else (0.0, 0.1)
    if "embedding" in name:
        return 0.0, math.sqrt(6.0 / (shape[0] + shape[1]))
    if name.endswith("weight"):
        if len(shape) == 2 and name.startswith("gnns.") \
                and name.count(".") == 2:             # gnns.i.weight (GCN)
            return 0.0, math.sqrt(6.0 / (2 * shape[0]))
        return 0.0, 1.0 / math.sqrt(shape[1])
    w = shapes.get(name[: -len("bias")] + "weight")
    fan_in = w[1] if w is not None and len(w) == 2 else shape[0]
    return 0.0, 1.0 / math.sqrt(fan_in)


def make(named_shapes: list[tuple[str, tuple]], seed: int, stream: int,
         device) -> dict[str, torch.Tensor]:
    """{name: f32 tensor on device} for the (name, shape) leaves, drawn in
    one call from a generator on `device` seeded by (seed, stream)."""
    total = sum(int(np.prod(s)) for _, s in named_shapes)
    word = int(np.random.SeedSequence([int(seed), 97, stream])
               .generate_state(1, np.uint64)[0] >> 1)
    gen = torch.Generator(device=device).manual_seed(word)
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    shapes = dict(named_shapes)
    out, off = {}, 0
    for name, shape in named_shapes:
        n = int(np.prod(shape))
        mid, half = _scale(name, shape, shapes)
        out[name] = (flat[off: off + n] * half + mid).reshape(shape)
        off += n
    return out


def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into the model's parameters in place (optimizer and
    captured graphs keep their tensors)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
