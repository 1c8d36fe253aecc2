"""Multi-head latent attention (DeepSeek-V2's), with q_lora 0: q = x·wq
split into a no-rope part and a rope part; the latent c = RMSNorm(x·W_dkv)
and one shared rope key k_r = rope(x·W_kr); per head k = [c·W_uk, k_r],
v = c·W_uv; softmax over (q_nope·k_nope + q_rope·k_r)/sqrt(nope + rope).

:func:`mla` is the expanded form a prompt is computed in; :func:`mla_decode`
is the absorbed form of one decode step over the latent cache (q_nope
folded through W_uk, W_uv applied after the weighted latent sum), the same
function rearranged.

Departures from the published model, as the configuration is run: RoPE in
the rotate-half layout on the rope dims (DeepSeek's code interleaves them,
a fixed permutation of those dims' weights) and no YaRN scaling (the
published rope_scaling factor 40 and its softmax mscale are not applied:
the configuration's file keeps the published group and says so with
``rope_scaling_applied`` false)."""
from __future__ import annotations

import math

import torch

from .common import causal_attention, mm, operand, rms_norm, rope


def _q(x, w, s, positions, precision):
    N, L, d = x.shape
    qd = s.nope + s.rope_dim
    q = mm(x, w["wq"].reshape(d, s.heads * qd), precision).view(N, L, s.heads, qd)
    return q[..., :s.nope], rope(q[..., s.nope:], positions, s.rope_theta)


def _latent(x, w, s, positions, precision):
    kv_a = mm(x, w["wkv_a"], precision)
    latent = rms_norm(kv_a[..., :s.kv_lora], w["kv_norm"], s.eps)
    k_rope = rope(kv_a[..., None, s.kv_lora:], positions, s.rope_theta)[:, :, 0]
    return latent, k_rope


def mla(x, w: dict, s, positions, precision: str = "fp32"):
    """x [N, L, d] (normed) -> [N, L, d]; ``w`` holds ``wq`` [d, H, nope +
    rope], ``wkv_a`` [d, kv_lora + rope], ``kv_norm``, ``wkv_b`` [kv_lora,
    H, nope + v], ``wo`` [H, v, d] in float32."""
    N, L, d = x.shape
    H = s.heads
    q_nope, q_rope = _q(x, w, s, positions, precision)
    latent, k_rope = _latent(x, w, s, positions, precision)
    kv = mm(latent, w["wkv_b"].reshape(s.kv_lora, -1), precision).view(
        N, L, H, s.nope + s.v_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([kv[..., :s.nope], k_rope[:, :, None].expand(N, L, H, s.rope_dim)],
                  dim=-1)
    out = causal_attention(q, k, kv[..., s.nope:], 1.0 / math.sqrt(s.nope + s.rope_dim),
                           precision)
    return mm(out.reshape(N, L, H * s.v_dim), w["wo"].reshape(H * s.v_dim, d),
              precision)


def mla_decode(x, w: dict, s, pos: int, latent_cache, k_rope_cache,
               precision: str = "fp32"):
    """One absorbed decode step: x [N, 1, d] (normed) at position ``pos``
    over the caches [N, pos, kv_lora] and [N, pos, rope] of the earlier
    positions; returns ([N, 1, d], the caches with this position)."""
    N, _, d = x.shape
    H, r = s.heads, s.kv_lora
    positions = torch.tensor([pos], device=x.device)
    q_nope, q_rope = _q(x, w, s, positions, precision)
    latent, k_rope = _latent(x, w, s, positions, precision)
    lat = torch.cat([latent_cache, latent], dim=1)
    kr = torch.cat([k_rope_cache, k_rope], dim=1)
    wkv_b = w["wkv_b"]
    q_eff = torch.einsum("nqhk,rhk->nqhr", operand(q_nope, precision),
                         operand(wkv_b[..., :s.nope], precision))
    logits = (torch.einsum("nqhr,nsr->nhqs", operand(q_eff, precision),
                           operand(lat, precision))
              + torch.einsum("nqhk,nsk->nhqs", operand(q_rope, precision),
                             operand(kr, precision))) / math.sqrt(s.nope + s.rope_dim)
    p = torch.softmax(logits, dim=-1)
    lat_sum = torch.einsum("nhqs,nsr->nqhr", operand(p, precision),
                           operand(lat, precision))
    out = torch.einsum("nqhr,rhv->nqhv", operand(lat_sum, precision),
                       operand(wkv_b[..., s.nope:], precision))
    y = mm(out.reshape(N, 1, H * s.v_dim), w["wo"].reshape(H * s.v_dim, d), precision)
    return y, lat, kr
