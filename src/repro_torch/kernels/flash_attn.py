"""``flash_attn``: causal attention for the LM prefill (kernel K5).

:func:`flash_attention` computes, for ``q`` [B, S, H, hd] and ``k``, ``v``
[B, S, K, hd] with K dividing H (query head h reads KV head h // (H/K), the
function of the reference's ``_repeat_kv`` without the repeat), causal
softmax attention with scale 1/√hd: masked logits are set to ``-2e38``, the
softmax is taken in float32, and the output [B, S, H, hd] has ``q``'s dtype.
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
support the head dims of the dense configs (128; 16 and 64 for the smoke
configs and tests), and the wrapper raises for anything else.
"""
from __future__ import annotations

import math

import torch

from . import build
from ._common import COUNT_LOCK, on_cpu

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS",
           "NEG_INF", "ROUTES", "launches", "route_launches"]

#: kernel launches since the count was last set to 0
launches = 0
#: the same launches by route (keys of ``ROUTES``)
route_launches = {"tensor_core": 0, "cuda_core": 0}

#: head dims the kernel is built for
HEAD_DIMS = (16, 64, 128)
#: the mask value of the reference (``flash_attn/kernel.py``, ``ref.py``)
NEG_INF = -2.0e38
#: dtype -> (route, C launch function, source under ``repro_torch/csrc``)
ROUTES = {torch.bfloat16: ("tensor_core", "flash_attn_tc_launch",
                           "flash_attn_tc.cu"),
          torch.float32: ("cuda_core", "flash_attn_launch", "flash_attn.cu")}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The materialized softmax of ``repro/kernels/flash_attn/ref.py``: the
    float32 logits ``(q·kᵀ)·scale`` [B, H, S, S], causal mask to ``-2e38``,
    softmax, ``·v``, cast to ``q``'s dtype. K/V heads are repeated to H."""
    B, S, H, hd = q.shape
    group = H // k.shape[2]
    qf = q.float().transpose(1, 2)                     # [B, H, S, hd]
    kf = k.repeat_interleave(group, dim=2).float().transpose(1, 2)
    vf = v.repeat_interleave(group, dim=2).float().transpose(1, 2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = torch.where(mask, logits, NEG_INF)
    out = torch.matmul(torch.softmax(logits, dim=-1), vf)
    return out.transpose(1, 2).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention: {k.shape[2]} KV heads do not "
                         f"divide {H} query heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} is not one of "
                         f"{HEAD_DIMS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Causal attention, ``[B, S, H, hd]`` out; see the module docstring."""
    global launches
    _check(q, k, v)
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: kernel inputs must be 16-byte "
                         "aligned")
    route, fn, _ = ROUTES[q.dtype]
    err = getattr(build.library(), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        k.shape[2], hd, 1.0 / math.sqrt(hd), build.stream_ptr(q))
    build.check(err, f"flash_attn ({route})")
    with COUNT_LOCK:
        launches += 1
        route_launches[route] += 1
    return out
