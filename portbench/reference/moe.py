"""The Mixture-of-Experts layer (DeepSeek-V2's routed and shared experts):
a softmax router over E experts, the top k of each token (ties to the
lower index), each expert a gated MLP, the token's output the gate-weighted
sum of its experts' outputs plus the shared experts' MLP.

Departures from the published model, as the configuration is run (its
file states them): each expert holds at most C = min(max(k, round(T·k/E·
capacity_factor)), T) of the T tokens of one call (a prefill's B·S, one
decode step's B), assignments taken in (token, rank) order and those past C
dropped (the shared experts still apply); the top-k gates renormalized to
sum 1 (``norm_topk_prob`` true); the balance loss is Switch's top-1 form,
E·Σ_e (share of tokens whose first choice is e)·(mean probability of e),
times ``aux_loss_coef`` in the loss (DeepSeek's sequence-wise loss at
0.001 is not run)."""
from __future__ import annotations

import torch

from .common import gated_mlp, mm


def capacity(T: int, k: int, E: int, factor: float) -> int:
    return int(min(max(k, round(T * k / E * factor)), T))


def route(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The k experts of largest probability per row, ties to the lower
    index."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    return order[:, :k]


def moe(x, w: dict, s, precision: str = "fp32"):
    """One call over the tokens x [T, d] -> (y [T, d], the balance loss)."""
    T, d = x.shape
    E, k = s.experts, s.top_k
    probs = torch.softmax(mm(x, w["router"], precision), dim=-1)
    eidx = route(probs, k)                                   # [T, k]
    gate = torch.gather(probs, 1, eidx)
    if s.norm_topk:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    first = torch.zeros(E, device=x.device).index_add_(
        0, eidx[:, 0], torch.ones(T, device=x.device)) / T
    aux = E * torch.sum(first * probs.mean(0))
    # arrival order: the slot of assignment i is the number of earlier
    # assignments (flat (token, rank) order) to the same expert
    e_flat = eidx.reshape(-1)
    onehot = torch.nn.functional.one_hot(e_flat, E)
    slot = (onehot.cumsum(0) - onehot).gather(1, e_flat[:, None])[:, 0]
    keep = slot < capacity(T, k, E, s.capacity_factor)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    g_flat = gate.reshape(-1)
    y = torch.zeros_like(x)
    for e in range(E):
        sel = torch.nonzero((e_flat == e) & keep)[:, 0]
        if sel.numel() == 0:
            continue
        t = tok[sel]
        out = gated_mlp(x[t], w["wg"][e], w["wu"][e], w["wd"][e], precision)
        y = y.index_add(0, t, out * g_flat[sel, None])
    if s.shared:
        y = y + gated_mlp(x, w["shared.wg"], w["shared.wu"], w["shared.wd"], precision)
    return y, aux
