"""Shared arithmetic of the reference: products in the precision asked for
(``fp8``: the control's float8 operands), RMS norm, rotary embeddings and
SiLU, all in float32."""
from __future__ import annotations

import math

import torch

#: the largest finite float8 e4m3 and e5m2 values
E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def strict_float32() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round8(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to the float8 ``dtype`` under one scale for the whole
    tensor (its largest magnitude to ``top``), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / top
    return (t / s).to(dtype).to(torch.float32) * s


class _Q8(torch.autograd.Function):
    """A product's operand in float8 as float8 training runs it: e4m3 in
    the forward, and the gradient that reaches it in e5m2, each under a
    scale of its own."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, E5M2_MAX)


def q8(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the control's operand (:class:`_Q8`)."""
    return _Q8.apply(t)


def operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    return q8(t) if precision == "fp8" else t


def mm(x: torch.Tensor, w: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """x [..., k] @ w [k, n] in float32 (fp8: both operands rounded)."""
    return operand(x, precision) @ operand(w, precision)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim of x [..., L, heads, dim] at
    ``positions`` [L]: the dim's two halves rotated by position ·
    theta^(-i/half) (the rotate-half layout)."""
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freq          # [L, half]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gated_mlp(x, wg, wu, wd, precision: str = "fp32"):
    """silu(x·wg) ∘ (x·wu) · wd."""
    return mm(silu(mm(x, wg, precision)) * mm(x, wu, precision), wd, precision)


def causal_attention(q, k, v, scale: float, precision: str = "fp32"):
    """Softmax attention of q [N, L, H, dqk] over k [N, L, H, dqk], v
    [N, L, H, dv] under the causal mask (query i sees keys j <= i), in
    float32; one sequence at a time to bound the score matrix."""
    N, L = q.shape[:2]
    mask = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    out = []
    for n in range(N):
        s = torch.einsum("lhd,mhd->hlm", operand(q[n], precision),
                         operand(k[n], precision)) * scale
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out.append(torch.einsum("hlm,mhd->lhd", operand(p, precision),
                                operand(v[n], precision)))
    return torch.stack(out)
