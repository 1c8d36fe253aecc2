"""int8 block-quantized gradients with error feedback:
``repro.parallel.collectives`` on one device.

The reference quantizes a step's gradients plus the carried residual in
blocks of 256 (a float32 scale a block, ``max|block| / 127 + 1e-12``,
values rounded half to even and clipped to ±127), lets the mesh all-reduce
the int8 payload, dequantizes, and carries the quantization error into the
next step (error feedback), so the compression stays unbiased over time.
:func:`ef_update` is the round trip the train loop's ``compress_grads``
calls. On one device there is nothing to all-reduce; under a mesh the
train step hands it the gradients already reduce-scattered to their ZeRO-1
specs (DTensor's collectives, ``train/loop.py``), as the reference's XLA
emits its reductions from the specs around the same round trip. Trees are
dicts of tensors keyed alike (the train state's parameter names). The
rest of ``parallel/`` is ``sharding.py``: the rules, the mesh and
``constraint``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["QuantGrads", "quantize_tree", "dequantize_tree", "ef_update",
           "init_error_feedback", "BLOCK"]

BLOCK = 256  # quantization block (a scale a block keeps outliers local)


class QuantGrads(NamedTuple):
    q: dict[str, torch.Tensor]      # int8 payloads [n_blocks, 256]
    scale: dict[str, torch.Tensor]  # float32 scales [n_blocks, 1]


def _quant_leaf(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % BLOCK)).view(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant_leaf(q: torch.Tensor, scale: torch.Tensor, like: torch.Tensor
                  ) -> torch.Tensor:
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[: like.numel()].reshape(like.shape).to(like.dtype)


def quantize_tree(grads: dict[str, torch.Tensor],
                  residual: dict[str, torch.Tensor]
                  ) -> tuple[QuantGrads, dict[str, torch.Tensor]]:
    """Quantize ``grads + residual``; return the payload and the new
    residual ``(g + e) - dequant(quant(g + e))`` (float32)."""
    qs, scales, new_resid = {}, {}, {}
    for k, g in grads.items():
        corrected = g + residual[k].to(g.dtype)
        qs[k], scales[k] = _quant_leaf(corrected)
        deq = _dequant_leaf(qs[k], scales[k], corrected)
        new_resid[k] = (corrected - deq).to(torch.float32)
    return QuantGrads(qs, scales), new_resid


def dequantize_tree(payload: QuantGrads, like: dict[str, torch.Tensor]
                    ) -> dict[str, torch.Tensor]:
    """The payload back in the shapes and dtypes of ``like``."""
    return {k: _dequant_leaf(payload.q[k], payload.scale[k], g)
            for k, g in like.items()}


def init_error_feedback(params: dict[str, torch.Tensor]
                        ) -> dict[str, torch.Tensor]:
    """Zero float32 residuals shaped as ``params``."""
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def ef_update(grads: dict[str, torch.Tensor],
              residual: dict[str, torch.Tensor]
              ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """The compress -> decompress round trip: (the gradients as the
    payload restores them, the new residual)."""
    payload, new_resid = quantize_tree(grads, residual)
    return dequantize_tree(payload, grads), new_resid
