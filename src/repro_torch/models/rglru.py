"""The RG-LRU recurrent block (RecurrentGemma / Griffin), ``repro.models.
rglru`` on PyTorch (recurrentgemma-9b's recurrent layers).

The recurrence ``h_t = a_t·h_{t-1} + sqrt(1 - a_t²)·(i_t·x_t)`` is diagonal
(per channel). The reference computes it outside any Pallas kernel, so this
module is plain torch on both devices, in the reference's own form:

- the x branch's temporal conv (width W, the W products summed in the
  compute dtype in the order i = 0..W-1, no activation) and the gate branch
  ``gelu(x·wg)`` (:func:`~.layers.gelu`, JAX's tanh form);
- ``_gates``: ``r = σ(x·wa)``, ``i = σ(x·wi)``, ``a = exp(8·r·log(σ(lam) +
  1e-9))``, in float32;
- the prefill: the reference's ``lax.associative_scan`` of ``combine((a1,
  b1), (a2, b2)) = (a1·a2, b1·a2 + b2)`` over time, as a log-depth scan:
  ⌈log2 S⌉ passes, pass k combining each step with the one 2^k before it
  (never a loop over the tokens). Its float32 products are taken in
  another order than JAX's tree, so h agrees to float32 rounding, not bit
  for bit;
- decode: one elementwise step, written into the layer's cache in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.parallel.sharding import constraint
from .layers import dense_init_, gelu, linear, param

__all__ = ["RGLRU", "rglru_apply", "LRUCache", "init_lru_cache", "scan"]

_C = 8.0  # Griffin's fixed recurrence-sharpness constant


class LRUCache(NamedTuple):
    conv: torch.Tensor   # [B, W-1, width] temporal-conv window (a model's: [L, B, ...])
    h: torch.Tensor      # [B, width] recurrent state, float32


#: one layer's cache axes (``init_lru_cache``'s)
LRU_CACHE_AXES = LRUCache(("batch", None, "width"), ("batch", "width"))


class RGLRU(torch.nn.Module):
    """The parameters of ``rglru_init``: ``wx``/``wg`` [d, w], ``conv_w``
    [W, w], ``wa``/``wi`` [w, 1] and ``wo`` [w, d] in bf16 (the reference's
    launcher casts every parameter of more than one dim); ``lam`` [w] in
    float32."""

    #: each parameter's logical axes (``rglru_init``'s)
    AXES = {"wx": ("embed_fsdp", "width"), "wg": ("embed_fsdp", "width"),
            "conv_w": (None, "width"), "wa": ("width", None),
            "wi": ("width", None), "lam": ("width",),
            "wo": ("width", "embed_fsdp")}

    def __init__(self, cfg, device=None):
        super().__init__()
        d, w = cfg.d_model, cfg.lru_width
        self.cfg = cfg
        self.wx = param((d, w), device)
        self.wg = param((d, w), device)
        self.conv_w = param((cfg.conv_width, w), device)
        self.wa = param((w, 1), device)
        self.wi = param((w, 1), device)
        self.lam = param((w,), device, torch.float32)
        self.wo = param((w, d), device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``rglru_init``'s distributions: fan-in truncated normals, the
        conv at scale 0.5, the gates at 0.1, ``lam`` 2 (σ(2) ≈ 0.88)."""
        dense_init_(self.wx, generator)
        dense_init_(self.wg, generator)
        dense_init_(self.conv_w, generator, scale=0.5)
        dense_init_(self.wa, generator, scale=0.1)
        dense_init_(self.wi, generator, scale=0.1)
        self.lam.fill_(2.0)
        dense_init_(self.wo, generator)

    def forward(self, x, cache=None, cache_pos=None):
        return rglru_apply(self, self.cfg, x, cache, cache_pos)


def _gates(p, xb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence and input gates (a_t, i_t) of the x branch [B, S, w],
    float32."""
    xf = xb.float()
    r = torch.sigmoid(xf * p.wa[:, 0].float()[None, None, :])
    i = torch.sigmoid(xf * p.wi[:, 0].float()[None, None, :])
    a_base = torch.sigmoid(p.lam.float())[None, None, :]
    a = torch.exp(_C * r * torch.log(a_base + 1e-9))   # a_base^(c·r_t)
    return a, i


def scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over dim 1 from h_{-1} = 0, for a, b [B, S,
    ...]: the inclusive scan of ``combine((a1, b1), (a2, b2)) = (a1·a2,
    b1·a2 + b2)``, in ⌈log2 S⌉ passes over the whole sequence."""
    S = a.shape[1]
    step = 1
    while step < S:
        b = torch.cat([b[:, :step], b[:, :-step] * a[:, step:] + b[:, step:]],
                      dim=1)
        if 2 * step < S:  # the last pass needs no products of a
            a = torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1)
        step *= 2
    return b


def rglru_apply(p, cfg, x: torch.Tensor, cache: Optional[LRUCache] = None,
                cache_pos: Optional[int] = None
                ) -> tuple[torch.Tensor, Optional[LRUCache]]:
    """``repro.models.rglru.rglru_apply``: x [B, S, d]. The scanned prefill
    when ``cache`` is None (returning the layer's LRUCache when
    ``cache_pos`` is given), else one decode step (S == 1) that writes
    ``cache`` in place."""
    B, S, d = x.shape
    dt = x.dtype
    xb = linear(x, p.wx.to(dt))
    gb = gelu(linear(x, p.wg.to(dt)))
    # the temporal conv on the x branch
    W = p.conv_w.shape[0]
    prev = xb.new_zeros((B, W - 1, xb.shape[-1])) if cache is None \
        else cache.conv
    xp = torch.cat([prev, xb], dim=1)
    xb = sum(xp[:, i: i + S] * p.conv_w[i].to(dt) for i in range(W))
    conv_new = xp[:, -(W - 1):]
    xb = constraint(xb, "batch", None, "width")

    a, i = _gates(p, xb)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * i * xb.float()

    if cache is None:  # prefill: the scan over time
        hs = scan(a, gated)
        new_cache = LRUCache(conv_new, hs[:, -1]) if cache_pos is not None \
            else None
    else:
        if S != 1:
            raise ValueError(f"rglru_apply: decode takes one token, got S={S}")
        h = a[:, 0] * cache.h + gated[:, 0]
        hs = h[:, None]
        cache.conv.copy_(conv_new)
        cache.h.copy_(h)
        new_cache = cache
    y = hs.to(dt) * gb
    return linear(y, p.wo.to(dt)), new_cache


def init_lru_cache(cfg, batch: int, dtype=torch.bfloat16, device=None,
                   n_layers: Optional[int] = None) -> LRUCache:
    """A zeroed cache: ``conv`` [B, W-1, width] in ``dtype``, ``h``
    [B, width] in float32; [n_layers, ...] each when given (a model's, its
    layers stacked)."""
    lead = (batch,) if n_layers is None else (n_layers, batch)
    return LRUCache(
        torch.zeros(lead + (cfg.conv_width - 1, cfg.lru_width), dtype=dtype,
                    device=device),
        torch.zeros(lead + (cfg.lru_width,), dtype=torch.float32,
                    device=device))
