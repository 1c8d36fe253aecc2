"""The head's next-token cross entropy: the mean over every position of
logsumexp(logits) − logit(label), logits = x·W_head in float32."""
from __future__ import annotations

import torch

from .common import mm


def cross_entropy(x, head, labels, precision: str = "fp32"):
    """x [B, S, d] (final-normed), head [d, V], labels [B, S]."""
    logits = mm(x, head, precision)
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (lse - lab).mean()
