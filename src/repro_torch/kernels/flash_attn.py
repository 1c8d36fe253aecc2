"""``flash_attn``: attention for the LM prefill (kernel K5).

:func:`flash_attention` computes, for ``q`` [B, S, H, Dqk], ``k`` [B, S,
K, Dqk] and ``v`` [B, S, K, Dv] with K dividing H (query head h reads KV
head h // (H/K), the function of the reference's ``_repeat_kv`` without the
repeat), softmax attention with scale 1/√Dqk unless ``scale`` is given:
causal by default, over the last ``window`` keys of each query when a
window is given (the reference's ``_sdpa`` mask: key j is seen by query i
when j <= i and j > i - window), or over all S keys with ``causal=False``
(the whisper encoder's self-attention, as ``ref.py`` and ``_sdpa`` compute
it; a window is refused there, since ``_sdpa`` applies one only under its
causal mask). Masked logits are set to ``-2e38``, the softmax is taken in
float32, and the output [B, S, H, Dv] has ``q``'s dtype. Dqk ≠ Dv is MLA's
un-absorbed prefill (q·k over the nope + rope dims, v at its own width).
On a CPU tensor it runs :func:`flash_attention_plain`; on a CUDA tensor it
launches the kernel of the inputs' dtype or raises. Each dtype has one
route (``ROUTES``), and neither gives way to the other:

- bfloat16: ``csrc/flash_attn_tc.cu``, tensor-core ``wgmma`` products on
  tiles that TMA loads into a shared-memory ring;
- float32: ``csrc/flash_attn.cu``, IEEE float32 on the CUDA cores (never
  TF32).

The kernels take the [B, S, H, hd] layout the model produces as it is (no
fold to [BH, S, hd], no padding of S or hd): the inputs must be contiguous
(and 16-byte aligned), and any other tensor is refused, never copied. They
are built for the ``(Dqk, Dv)`` pairs of ``HEAD_DIMS``: the dense configs'
(128, 128), recurrentgemma-9b's (256, 256) (16 query heads on one KV head,
a window of 2048) and the smoke/test dims (16, 16) and (64, 64); MLA's (96, 64)
(minicpm3-4b), (192, 128) (deepseek-v2-lite: 128 nope + 64 rope, v 128)
and (32, 16) (the MLA smoke dims 24/16 with q and k zero-padded to 32 by
the caller). The wrapper raises for anything else.
"""
from __future__ import annotations

import math

import torch

from . import build
from ._common import COUNT_LOCK, on_cpu

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS",
           "NEG_INF", "ROUTES", "launches", "route_launches",
           "class_launches"]

#: kernel launches since the count was last set to 0
launches = 0
#: the same launches by route (keys of ``ROUTES``)
route_launches = {"tensor_core": 0, "cuda_core": 0}
#: the same launches by mask: causal (with or without a window) or not
class_launches = {"causal": 0, "noncausal": 0}

#: the (q·k head dim, v head dim) pairs the kernels are built for
HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (256, 256), (96, 64),
             (192, 128), (32, 16))
#: the mask value of the reference (``flash_attn/kernel.py``, ``ref.py``)
NEG_INF = -2.0e38
#: dtype -> (route, C launch function, source under ``repro_torch/csrc``)
ROUTES = {torch.bfloat16: ("tensor_core", "flash_attn_tc_launch",
                           "flash_attn_tc.cu"),
          torch.float32: ("cuda_core", "flash_attn_launch", "flash_attn.cu")}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, scale: float | None = None,
                          window: int | None = None,
                          causal: bool = True) -> torch.Tensor:
    """The materialized softmax of ``repro/kernels/flash_attn/ref.py``: the
    float32 logits ``(q·kᵀ)·scale`` [B, H, S, S] (scale 1/√Dqk by default),
    causal mask to ``-2e38`` (keys j <= i, and j > i - ``window`` when a
    window is given, as the reference's ``_sdpa`` masks them; no mask with
    ``causal=False``), softmax, ``·v`` [B, S, K, Dv], cast to ``q``'s dtype.
    K/V heads are repeated to H."""
    B, S, H, dqk = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(dqk)
    group = H // k.shape[2]
    qf = q.float().transpose(1, 2)                     # [B, H, S, Dqk]
    kf = k.repeat_interleave(group, dim=2).float().transpose(1, 2)
    vf = v.repeat_interleave(group, dim=2).float().transpose(1, 2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        ones = torch.ones((S, S), dtype=torch.bool, device=q.device)
        mask = ones.tril()
        if window:
            mask &= ~ones.tril(-window)
        logits = torch.where(mask, logits, NEG_INF)
    out = torch.matmul(torch.softmax(logits, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"flash_attention: {name} must be a torch.Tensor")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be [B, S, heads, "
                             f"hd], got shape {tuple(t.shape)}")
        if t.dtype not in ROUTES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; the "
                            "kernel takes float32 or bfloat16")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: dtypes differ ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    B, S, H, dqk = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[:2] != (B, S) or \
            k.shape[3] != dqk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention: {k.shape[2]} KV heads do not "
                         f"divide {H} query heads")
    if (dqk, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (q·k {dqk}, v "
                         f"{v.shape[3]}) are not one of {HEAD_DIMS}")
    if window is not None and (not isinstance(window, int) or window < 1):
        raise ValueError(f"flash_attention: window must be a positive int "
                         f"or None, got {window!r}")
    if window is not None and not causal:
        raise ValueError("flash_attention: a window needs the causal mask "
                         "(the reference's _sdpa applies one only with it)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, window: int | None = None,
                    causal: bool = True) -> torch.Tensor:
    """Causal attention (over the last ``window`` keys when given), or
    bidirectional with ``causal=False``; ``[B, S, H, Dv]`` out; see the
    module docstring."""
    global launches
    causal = bool(causal)
    _check(q, k, v, window, causal)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale, window, causal)
    B, S, H, dqk = q.shape
    dv = v.shape[3]
    out = q.new_empty((B, S, H, dv))
    if B == 0 or S == 0:
        return out
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: kernel inputs must be 16-byte "
                         "aligned")
    route, fn, _ = ROUTES[q.dtype]
    err = getattr(build.library(), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        k.shape[2], dqk, dv, window or 0, int(causal), scale,
        build.stream_ptr(q))
    build.check(err, f"flash_attn ({route})")
    with COUNT_LOCK:
        launches += 1
        route_launches[route] += 1
        class_launches["causal" if causal else "noncausal"] += 1
    return out
