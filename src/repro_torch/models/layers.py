"""Shared model building blocks: the math of ``repro.models.layers`` on
tensors, and initializers that draw from an explicit ``torch.Generator``.

Compute is bf16 with float32 norm and rotary internals, cast back to the
input dtype in the reference's order. Parameters are stored as the serving
path uses them: matrices in bf16, norm scales in float32 (the reference's
launcher casts every parameter with more than one dim to bf16 and keeps the
rest). ``cross_entropy`` is the training loss's (its logits the bf16
product cast to float32, as the reference makes them); the reference's
``stack_inits`` has no counterpart: the port's blocks are one module each.
"""
from __future__ import annotations

import math
import torch
import torch.nn.functional as F

__all__ = ["dense_init_", "embedding_init_", "normal_init_",
           "rms_norm_init_", "rms_norm",
           "rope", "gated_mlp", "embed", "lm_head", "GatedMLP", "param",
           "silu", "gelu", "softplus", "cross_entropy"]

#: float32 elements drawn at a time when a bf16 tensor is initialized, so a
#: full-width embedding (131072 x 5120) never has a float32 copy
_INIT_CHUNK = 1 << 24
_SQRT2 = math.sqrt(2.0)
#: Φ(-2) and Φ(2), the truncation bounds of ``dense_init`` as CDF values
_PHI_M2 = (1.0 + math.erf(-2.0 / _SQRT2)) / 2.0
_PHI_P2 = (1.0 + math.erf(2.0 / _SQRT2)) / 2.0


def param(shape: tuple[int, ...], device, dtype=torch.bfloat16
          ) -> torch.nn.Parameter:
    """An uninitialized serving parameter (no gradient)."""
    return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                              requires_grad=False)


def _fill_(w: torch.Tensor, draw, scale: float) -> torch.Tensor:
    """Fill ``w`` with ``scale * draw(buf)`` computed in float32, chunk by
    chunk, each chunk rounded once into ``w``'s dtype."""
    flat = w.view(-1)
    buf = torch.empty(min(flat.numel(), _INIT_CHUNK), dtype=torch.float32,
                      device=w.device)
    for i in range(0, flat.numel(), buf.numel()):
        part = buf[: min(buf.numel(), flat.numel() - i)]
        draw(part)
        flat[i: i + part.numel()].copy_(part.mul_(scale))
    return w


@torch.no_grad()
def dense_init_(w: torch.Tensor, generator: torch.Generator,
                scale: float | None = None) -> torch.Tensor:
    """``repro.models.layers.dense_init``: a standard normal truncated to
    [-2, 2] (by its inverse CDF), times ``scale`` (``1/sqrt(shape[0])``
    unless given)."""
    def draw(buf):
        buf.uniform_(2.0 * _PHI_M2 - 1.0, 2.0 * _PHI_P2 - 1.0,
                     generator=generator)
        buf.erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)

    return _fill_(w, draw, 1.0 / math.sqrt(w.shape[0]) if scale is None
                  else scale)


@torch.no_grad()
def normal_init_(w: torch.Tensor, generator: torch.Generator,
                 scale: float) -> torch.Tensor:
    """A standard normal times ``scale``."""
    return _fill_(w, lambda buf: buf.normal_(generator=generator), scale)


def embedding_init_(w: torch.Tensor, generator: torch.Generator
                    ) -> torch.Tensor:
    """``embedding_init``: a standard normal times ``1/sqrt(d)``."""
    return normal_init_(w, generator, 1.0 / math.sqrt(w.shape[1]))


@torch.no_grad()
def rms_norm_init_(w: torch.Tensor) -> torch.Tensor:
    """``rms_norm_init``: ones."""
    return w.fill_(1.0)


# ------------------------------------------------------------------ compute
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` step by step: ``x * (1 / (1 + exp(-x)))``, each
    operation in ``x``'s dtype."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` at its default, the tanh approximation
    ``x · 0.5 · (1 + tanh(√(2/π) · (x + 0.044715 · x³)))`` (``F.gelu``'s
    default is the erf form, another function), each operation in ``x``'s
    dtype with the constants rounded to it first, as JAX rounds them."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` = ``max(x, 0) +
    log1p(exp(-|x|))``, with no threshold (``F.softplus`` switches to
    ``x`` past 20)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding on the last dim of ``x`` [..., S, n, d] with
    ``positions`` [..., S] (broadcastable)."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freq          # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                 # over the heads dim
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def gated_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """``silu(x·wg) * (x·wu) · wd`` for ``p`` with ``wg``/``wu`` [d, ff] and
    ``wd`` [ff, d], with :func:`silu` (``jax.nn.silu``'s steps; ``F.silu``
    rounds once and moves about a third of bf16 values by an ulp)."""
    dt = x.dtype
    h = silu(x @ p.wg.to(dt)) * (x @ p.wu.to(dt))
    return h @ p.wd.to(dt)


def embed(table: torch.Tensor, tokens: torch.Tensor,
          dtype=torch.bfloat16) -> torch.Tensor:
    return F.embedding(tokens, table.to(dtype))


def lm_head(table_or_w: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    """Logits [..., V]. ``tied`` uses the embedding table transposed."""
    w = table_or_w.to(x.dtype)
    return x @ (w.T if tied else w)


class GatedMLP(torch.nn.Module):
    """The parameters of ``gated_mlp_init``: ``wg``, ``wu`` [d, ff] and
    ``wd`` [ff, d]."""

    def __init__(self, d: int, ff: int, device=None):
        super().__init__()
        self.wg = param((d, ff), device)
        self.wu = param((d, ff), device)
        self.wd = param((ff, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wg, self.wu, self.wd):
            dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gated_mlp(self, x)


def cross_entropy(head_w: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, tied: bool,
                  n_chunks: int = 1) -> torch.Tensor:
    """``repro.models.layers.cross_entropy``: the mean next-token cross
    entropy over the positions where ``mask`` [B, S] holds, of the hidden
    states ``x`` [B, S, d] against ``labels`` [B, S]. The logits are the
    product ``x @ w`` in ``x``'s dtype (bf16) cast to float32, ``w`` the
    head [d, V] (``tied``: the embedding [V, d] transposed). With
    ``n_chunks > 1`` the vocab streams in ``n_chunks`` slices of V /
    n_chunks columns with a running max, sum and label logit (exact, as the
    reference's scan), so [B, S, V] is never materialized."""
    w = head_w.T if tied else head_w                  # [d, V] either way
    V = w.shape[-1]
    maskf = mask.float()
    denom = torch.clamp(maskf.sum(), min=1.0)
    if n_chunks <= 1:
        logits = (x @ w.to(x.dtype)).float()
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
        return torch.sum((lse - lab) * maskf) / denom
    if V % n_chunks:
        raise ValueError(f"cross_entropy: {n_chunks} chunks do not divide "
                         f"the vocab {V}")
    C = V // n_chunks
    B, S = labels.shape
    m = torch.full((B, S), -math.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    lab = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        logits = (x @ w[:, i * C:(i + 1) * C].to(x.dtype)).float()
        new_m = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - new_m) + torch.sum(
            torch.exp(logits - new_m[..., None]), dim=-1)
        local = labels - i * C
        hit = (local >= 0) & (local < C)
        lab_logit = torch.take_along_dim(
            logits, local.clamp(0, C - 1)[..., None], dim=-1)[..., 0]
        lab = torch.where(hit, lab_logit, lab)
        m = new_m
    lse = m + torch.log(s)
    return torch.sum((lse - lab) * maskf) / denom
