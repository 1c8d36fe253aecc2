"""AdamW with float32 masters: the gradients clipped to a global norm,
bias-corrected moments, decoupled weight decay on every leaf, and the
learning rate of a linear warm-up then a cosine (step 0 already trains:
s = step + 1), as the training mix states them."""
from __future__ import annotations

import math

import torch


def lr_at(step: int, base: float, warmup: int, total: int, min_ratio: float) -> float:
    s = step + 1.0
    warm = min(s / max(warmup, 1), 1.0)
    prog = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return base * warm * (min_ratio + (1 - min_ratio) * cos)


@torch.no_grad()
def clip_scale(grads: dict, clip: float) -> torch.Tensor:
    gsq = sum(torch.sum(g.double() * g.double()) for g in grads.values())
    return torch.clamp(clip / (torch.sqrt(gsq) + 1e-9), max=1.0).float()


@torch.no_grad()
def adamw_step(params: dict, grads: dict, m: dict, v: dict, step: int, lr: float,
               b1: float, b2: float, eps: float, wd: float, clip: float) -> dict:
    """One step in place; returns the clipped gradients' norms by leaf."""
    scale = clip_scale(grads, clip)
    t = step + 1
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    norms = {}
    for k, p in params.items():
        g = grads[k] * scale
        norms[k] = float(torch.linalg.vector_norm(g))
        m[k].mul_(b1).add_(g, alpha=1 - b1)
        v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
        p.sub_(lr * ((m[k] / c1) / (torch.sqrt(v[k] / c2) + eps) + wd * p))
    return norms
