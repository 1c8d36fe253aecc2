"""AdamW with float32 master weights: ``repro.train.optimizer`` on one
device.

A :class:`TrainState` holds the step and three dicts of float32 tensors
keyed alike, the masters, the first and the second moments; the port keys
them by the ``LM``'s parameter names (``embed``, ``layers.0.attn.wq``, ...;
:func:`repro_torch.convert.train_state_from_numpy` maps the reference's
tree onto them). :func:`adamw_update` is the reference's arithmetic,
operation for operation in float32: the global-norm clip over every
gradient, bias correction, and decoupled weight decay on every leaf.
Unlike the reference, which returns new arrays (and donates the old ones
under ``jit``), it updates the masters and moments in place, leaf by leaf,
so a step holds no second copy of the state. The reference's ZeRO-1
specs (``zero1_spec``, ``tree_zero1_specs``) shard the state over a mesh;
they go with ``parallel/`` (ROADMAP queue 1, item 14b.8).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["TrainState", "LRSchedule", "cosine_lr", "adamw_init",
           "adamw_update"]


class TrainState(NamedTuple):
    step: torch.Tensor               # int32 scalar, on the masters' device
    params: dict[str, torch.Tensor]  # float32 master weights
    m: dict[str, torch.Tensor]       # first moment (float32)
    v: dict[str, torch.Tensor]       # second moment (float32)


class LRSchedule(NamedTuple):
    base: float = 3e-4
    warmup: int = 100
    total: int = 10000
    min_ratio: float = 0.1


def cosine_lr(sched: LRSchedule, step: torch.Tensor) -> torch.Tensor:
    """``repro.train.optimizer.cosine_lr``: linear warmup to ``base`` over
    ``warmup`` steps, then a cosine to ``base·min_ratio`` at ``total``;
    step 0 already trains (s = step + 1). Float32, on ``step``'s device."""
    s = step.to(torch.float32) + 1.0
    warm = torch.clamp(s / max(sched.warmup, 1), max=1.0)
    prog = torch.clamp((s - sched.warmup) /
                       max(sched.total - sched.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return sched.base * warm * (sched.min_ratio + (1 - sched.min_ratio) * cos)


def adamw_init(params: dict[str, torch.Tensor]) -> TrainState:
    """The state at step 0: ``params`` (float32 masters, kept, not copied)
    and zero moments on their devices."""
    first = next(iter(params.values()))
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return TrainState(torch.zeros((), dtype=torch.int32, device=first.device),
                      params, zeros,
                      {k: torch.zeros_like(z) for k, z in zeros.items()})


@torch.no_grad()
def adamw_update(state: TrainState, grads: dict[str, torch.Tensor],
                 lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, wd: float = 0.1,
                 clip: float = 1.0) -> TrainState:
    """One AdamW step of ``repro.train.optimizer.adamw_update`` on
    ``grads`` (keyed as the masters; any float dtype: each is cast to
    float32 where it is used, as the reference casts, so bf16 gradients
    give what their float32 casts give without a float32 copy of all of
    them). The masters and moments are updated in place; returns the state
    with the step advanced."""
    gsq = None
    for k in state.params:  # the global norm, summed leaf by leaf in order
        part = torch.sum(torch.square(grads[k].to(torch.float32)))
        gsq = part if gsq is None else gsq + part
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(clip / (gnorm + 1e-9), max=1.0)
    t = state.step.to(torch.float32) + 1.0
    c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
    for k, p in state.params.items():
        g = grads[k].to(torch.float32) * scale
        m, v = state.m[k], state.v[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        p.sub_(lr * (step + wd * p))
    return TrainState(state.step + 1, state.params, state.m, state.v)
