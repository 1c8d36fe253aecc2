"""The whole model of a configuration, assembled from the reference's
parts: the token embedding, pre-norm blocks (RMSNorm, attention — GQA or
MLA —, RMSNorm, a gated MLP or the MoE layer, each added to the residual
stream), a final RMSNorm and the untied head. Weights come from a callable
``weight(name) -> float32 tensor`` so that they are drawn one layer at a
time.

:func:`served_logits` is what a served request's tokens are judged by: the
logits at every position that produced a served token, over the prompt and
the served tokens (teacher forced). The MoE layer's capacity counts over
the tokens of one call, so it is applied as serving calls it: one call
over the whole batch's prompts, then one over the batch's tokens at each
generated position. :func:`train_readings` runs training steps with AdamW
and reads what the training check compares.
"""
from __future__ import annotations

import statistics

import torch
from torch.utils.checkpoint import checkpoint

from .adamw import adamw_step, lr_at
from .common import gated_mlp, mm, rms_norm
from .dense import gqa
from .mla import mla
from .moe import moe
from .xent import cross_entropy


def layer_names(s, i: int) -> list[str]:
    p = f"layers.{i}."
    return [n[len(p):] for n in s.leaves() if n.startswith(p)]


def _attention(s, h, w, positions, precision):
    return (mla if s.attn == "mla" else gqa)(h, w, s, positions, precision)


@torch.no_grad()
def served_logits(s, weight, tokens: torch.Tensor, prompt_len: int,
                  precision: str = "fp32", rows: int = 8) -> torch.Tensor:
    """tokens [N, L]: N requests of one served batch, in its order (the
    prompt, then the served tokens but the last) -> the logits [N, L −
    prompt_len + 1, V] at positions prompt_len − 1 … L − 1. ``rows``
    sequences at a time through a dense layer."""
    N, L = tokens.shape
    positions = torch.arange(L, device=tokens.device)
    x = weight("embed")[tokens]                                 # [N, L, d]
    for i in range(s.n_layers):
        w = {n: weight(f"layers.{i}.{n}") for n in layer_names(s, i)}
        attn_w = {n[5:]: t for n, t in w.items() if n.startswith("attn.")}
        for r in range(0, N, rows):
            xs = x[r:r + rows]
            xs += _attention(s, rms_norm(xs, w["ln1"], s.eps), attn_w,
                             positions, precision)
            if not s.is_moe_layer(i):
                xs += gated_mlp(rms_norm(xs, w["ln2"], s.eps), w["mlp.wg"],
                                w["mlp.wu"], w["mlp.wd"], precision)
        if s.is_moe_layer(i):
            moe_w = {n[4:]: t for n, t in w.items() if n.startswith("moe.")}
            h = rms_norm(x, w["ln2"], s.eps)
            d = h.shape[-1]
            y = torch.empty_like(h)
            y[:, :prompt_len] = moe(h[:, :prompt_len].reshape(-1, d), moe_w, s,
                                    precision)[0].view(N, prompt_len, d)
            for p in range(prompt_len, L):
                y[:, p] = moe(h[:, p], moe_w, s, precision)[0]
            x += y
        del w
    h = rms_norm(x[:, prompt_len - 1:], weight("final_ln"), s.eps)
    return mm(h, weight("head"), precision)


def _block(s, i, precision, x, positions, *ws):
    names = layer_names(s, i)
    w = dict(zip(names, ws))
    attn_w = {n[5:]: t for n, t in w.items() if n.startswith("attn.")}
    x = x + _attention(s, rms_norm(x, w["ln1"], s.eps), attn_w, positions, precision)
    h = rms_norm(x, w["ln2"], s.eps)
    if s.is_moe_layer(i):
        moe_w = {n[4:]: t for n, t in w.items() if n.startswith("moe.")}
        B, S, d = h.shape
        y, aux = moe(h.reshape(B * S, d), moe_w, s, precision)
        return x + y.view(B, S, d), aux
    return x + gated_mlp(h, w["mlp.wg"], w["mlp.wu"], w["mlp.wd"], precision), \
        torch.zeros((), device=x.device)


def loss(s, params: dict, tokens: torch.Tensor, precision: str = "fp32",
         remat: bool = True):
    """The training loss of tokens [B, S + 1] (inputs ``[:, :-1]``, labels
    ``[:, 1:]``): the mean cross entropy plus ``aux_coef`` times the MoE
    layers' balance losses summed; each block recomputed in the backward
    with ``remat``."""
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    positions = torch.arange(inputs.shape[1], device=tokens.device)
    x = params["embed"][inputs]
    aux = torch.zeros((), device=tokens.device)
    for i in range(s.n_layers):
        ws = [params[f"layers.{i}.{n}"] for n in layer_names(s, i)]
        if remat:
            x, a = checkpoint(_block, s, i, precision, x, positions, *ws,
                              use_reentrant=False)
        else:
            x, a = _block(s, i, precision, x, positions, *ws)
        aux = aux + a
    ce = cross_entropy(rms_norm(x, params["final_ln"], s.eps), params["head"],
                       labels, precision)
    return ce + s.aux_coef * aux


def train_readings(s, master, batches: list, opt: dict, precision: str = "fp32",
                   remat: bool = True) -> dict:
    """Len(batches) AdamW steps from the masters ``master(name)`` (float32)
    -> {"loss": each step's loss, "grad": each leaf's gradient norm as the
    first step's update uses it (after the clip), "delta": each leaf's
    change over the steps}. ``opt``: the mix's optimizer settings."""
    names = list(s.leaves())
    params = {n: master(n).requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad = [], None
    for step, tokens in enumerate(batches):
        lval = loss(s, params, tokens, precision, remat)
        grads = dict(zip(names, torch.autograd.grad(lval, list(params.values()))))
        lr = lr_at(step, opt["lr"], opt["warmup"], opt["total_steps"],
                   opt["min_lr_ratio"])
        norms = adamw_step(params, grads, m, v, step, lr, opt["b1"], opt["b2"],
                           opt["eps"], opt["weight_decay"], opt["grad_clip"])
        del grads
        losses.append(float(lval.detach()))
        grad = grad or norms
    del m, v
    with torch.no_grad():
        delta = {n: float(torch.linalg.vector_norm(params[n] - master(n)))
                 for n in names}
    return {"loss": losses, "grad": grad, "delta": delta}


def leaf_gaps(program: dict, reference: dict, keep=None) -> dict:
    """|program − reference| by leaf, each against the larger of the
    reference's value for that leaf and its median leaf's; ``keep`` names
    the leaves compared (default: all)."""
    names = [n for n in reference if keep is None or n in keep]
    med = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], med, 1e-30)
            for n in names}


def worst_leaf_gap(program: dict, reference: dict, keep=None) -> tuple[float, str]:
    """The largest of :func:`leaf_gaps` and its leaf."""
    gaps = leaf_gaps(program, reference, keep)
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_leaf_gap(program: dict, reference: dict, keep=None) -> float:
    """The median of :func:`leaf_gaps`."""
    return statistics.median(leaf_gaps(program, reference, keep).values())
