"""Weights and inputs drawn from the run's seed, on the device.

Every weight has its own generator, seeded from the run's seed and the
weight's name, so any one weight can be drawn again alone: the program's
weights are drawn into its parameters during set-up, and the reference
draws the same values again, layer by layer, once the program's state is
freed. A matrix is normal with std 1/sqrt(fan-in), the embedding table
normal with std 1/sqrt(d), a norm scale ones. Each is one ``normal_`` call
in the dtype it is served or trained in.
"""
from __future__ import annotations

import hashlib
import math

import torch

from .sizes import Sizes


def stream_seed(seed: int, *name) -> int:
    """A 63-bit seed for the stream ``name`` of run ``seed``."""
    h = hashlib.sha256(":".join(map(str, (int(seed),) + name)).encode())
    return int.from_bytes(h.digest()[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *name) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *name))


@torch.no_grad()
def draw_(t: torch.Tensor, seed: int, name: str, fan_in, d: int) -> torch.Tensor:
    """Fill ``t`` with weight ``name`` of run ``seed``."""
    if fan_in == "norm":
        return t.fill_(1.0)
    std = 1.0 / math.sqrt(d if fan_in == "embed" else fan_in)
    return t.normal_(0.0, std, generator=generator(t.device, seed, "w", name))


def leaf(sizes: Sizes, seed: int, name: str, dtype, device) -> torch.Tensor:
    """Weight ``name`` drawn anew in ``dtype`` (norm scales: float32)."""
    shape, fan_in = sizes.leaves()[name]
    dt = torch.float32 if fan_in == "norm" else dtype
    return draw_(torch.empty(shape, dtype=dt, device=device), seed, name,
                 fan_in, sizes.d)


def fill_named_(named: dict[str, torch.Tensor], sizes: Sizes, seed: int) -> None:
    """Draw every weight of ``named`` (``{name: tensor}``, the program's
    parameters or masters) in place, after checking that its names and
    shapes are the configuration's, so both sides get the same weights."""
    want = sizes.leaves()
    if set(named) != set(want):
        raise ValueError("the program's parameters are not the configuration's:"
                         f" missing {sorted(set(want) - set(named))[:5]}, extra "
                         f"{sorted(set(named) - set(want))[:5]}")
    for name, t in named.items():
        shape, fan_in = want[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: the program holds {tuple(t.shape)}, the "
                             f"configuration {shape}")
        draw_(t, seed, name, fan_in, sizes.d)


def tokens(device, seed: int, stream: str, index: int, shape, vocab: int
           ) -> torch.Tensor:
    """Token ids uniform over the vocabulary, the same for the same seed,
    stream and index."""
    return torch.randint(0, vocab, tuple(shape), device=device,
                         generator=generator(device, seed, stream, index))
