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
so a step holds no second copy of the state.

ZeRO-1 (:func:`zero1_spec`, :func:`tree_zero1_specs`): the masters and
moments take the tensor-parallel spec of their parameter plus data-parallel
sharding of the largest unsharded dim that the data-parallel degree
divides. The reference picks that dim on its *stacked* leaf ``[layers,
...]``; the port's blocks are one module each, so where the reference's
choice is the layer dim, the port's unstacked leaf picks another dim or
none (ROADMAP queue 3 lists every such leaf of the registry).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.parallel.sharding import AxisRules, P, _is_axes

__all__ = ["TrainState", "LRSchedule", "cosine_lr", "adamw_init",
           "adamw_update", "zero1_spec", "tree_zero1_specs"]


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


# ---------------------------------------------------------------- ZeRO-1
def zero1_spec(base: P, shape: tuple[int, ...], rules: AxisRules) -> P:
    """``base`` with data-parallel sharding added to the largest unsharded
    dim that the data-parallel degree divides (the last such dim on a
    tie); ``base`` itself where the mesh has no data axis, ``base`` uses
    one already, or no dim fits."""
    if not rules.axis_sizes:
        return base
    dp_axes = tuple(a for a in ("pod", "data") if a in rules.axis_sizes)
    if not dp_axes:
        return base
    dp = 1
    for a in dp_axes:
        dp *= rules.axis_sizes[a]
    entries = list(base) + [None] * (len(shape) - len(base))
    taken = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                taken.add(a)
    if any(a in taken for a in dp_axes):
        return base
    cand = [(shape[i], i) for i in range(len(shape))
            if entries[i] is None and shape[i] % dp == 0 and shape[i] >= dp]
    if not cand:
        return base
    _, i = max(cand)
    entries[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    while entries and entries[-1] is None:
        entries.pop()
    return P(*entries)


def tree_zero1_specs(axes_tree, params, rules: AxisRules):
    """The ZeRO-1 :class:`P` of every leaf of the masters (or m, v): a tree
    of logical-axes tuples (``param_axes``' ``{name: axes}``) and a
    matching tree of tensors."""
    def walk(a, p):
        if _is_axes(a):
            return zero1_spec(rules.spec(a, p.shape), tuple(p.shape), rules)
        if isinstance(a, dict):
            return {k: walk(a[k], p[k]) for k in a}
        return type(a)(walk(x, y) for x, y in zip(a, p))

    return walk(axes_tree, params)
