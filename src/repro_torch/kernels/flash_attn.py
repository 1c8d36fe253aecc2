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

A query shard (sequence parallelism): ``q`` [B, Sq, H, Dqk] may be rows
``q_offset`` … ``q_offset + Sq`` of a sequence whose keys ``k``/``v`` [B, Sk,
K, ·] are whole (Sq ≤ Sk, and ``q_offset + Sq`` ≤ Sk under the causal
mask). Query row i is then at position ``q_offset + i``: under ``causal``
it sees key j when j <= q_offset + i (and j > q_offset + i - window), the
reference's ``_sdpa`` mask with ``qpos = q_offset + arange(Sq)`` and ``kpos
= arange(Sk)``; without the causal mask the offset changes nothing. The
output is [B, Sq, H, Dv]; the backward's dk/dv cover all Sk keys (exact
zeros for the keys no row of the shard sees), so the shards' dk/dv sum to
the unsharded call's.
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

Training: where a CUDA call needs a gradient (grad mode on and an input
that requires one), :func:`flash_attention` runs through an
``autograd.Function`` whose forward launches the bf16 kernel with its row
statistic (:func:`flash_attention_lse`: each row's log2-sum-exp2 of the
scaled logits, [B, H, S] float32) and its output's low part (the float32
output less its bf16 rounding, in bf16: the backward's D = rowsum(dO∘O)
from the output to ~16 bits) and whose backward launches
``csrc/flash_attn_bwd.cu`` (:func:`flash_attention_backward`): on Hopper
tensor cores (``wgmma`` on tiles that TMA loads into an ``mbarrier``
ring), two kernel launches a call: dQ (which also writes each row's
D = rowsum(dO∘O)), then dK/dV, whose blocks sum a split of each KV head's
query heads and add the splits' float32 partials in a fixed order
(:func:`bwd_plan`). No float atomics, so a call repeats bit for bit. Both
kernels run on the H100 in ``chip_smoke.py``'s training phase. The
backward takes every mask of the forward (causal, a window, ``causal=False``)
as run-time arguments, bf16, at every head-dim pair of ``HEAD_DIMS``
(``BWD_HEAD_DIMS``); a call that needs a gradient of float32 inputs raises
``NotImplementedError`` (nothing detaches the output and nothing falls back
to the plain version). On the CPU the plain version runs and autograd
differentiates it.
"""
from __future__ import annotations

import math

import torch

from . import build
from ._common import COUNT_LOCK, on_cpu

__all__ = ["flash_attention", "flash_attention_plain", "HEAD_DIMS",
           "NEG_INF", "ROUTES", "launches", "route_launches",
           "class_launches", "flash_attention_lse", "flash_attention_lse_plain",
           "flash_attention_backward", "flash_attention_backward_plain",
           "BWD_HEAD_DIMS", "LOG2E", "bwd_launches", "bwd_head_dim_launches",
           "bwd_plan", "BWD_MIN_BLOCKS", "BWD_MAX_SPLITS", "bwd_class_launches"]

#: kernel launches since the count was last set to 0
launches = 0
#: the same launches by route (keys of ``ROUTES``)
route_launches = {"tensor_core": 0, "cuda_core": 0}
#: the same launches by mask: causal (with or without a window) or not; a
#: query shard (Sq < Sk or an offset) under a key of its own
class_launches = {"causal": 0, "noncausal": 0, "query_shard": 0}

#: backward launches (one a call of ``flash_attn_bwd_launch``, whose two
#: kernels, dQ then dK/dV, run as one) since the count was last set to 0
bwd_launches = 0
#: the same by (q·k head dim, v head dim)
bwd_head_dim_launches: dict[tuple[int, int], int] = {}
#: the same by mask: causal, causal over a window, or not causal; a query
#: shard under a key of its own
bwd_class_launches = {"causal": 0, "window": 0, "noncausal": 0,
                      "query_shard": 0}

#: the (q·k head dim, v head dim) pairs the kernels are built for
HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (256, 256), (96, 64),
             (192, 128), (32, 16))
#: the pairs the backward kernel is built for: those of the forward, the
#: dense configs' 128/128, whisper-tiny's and qwen3-100m's 64/64,
#: recurrentgemma-9b's 256/256, the smoke dims' 16/16, and MLA's (96, 64)
#: (minicpm3-4b), (192, 128) (deepseek-v2-lite-16b) and (32, 16) (the MLA
#: smoke dims 24/16, q and k zero-padded to 32 by the caller)
BWD_HEAD_DIMS = HEAD_DIMS
#: the dK/dV launch's grid aim: a wave of the H100's 132 SMs (a dK/dV block
#: takes an SM's registers and most of its shared memory)
BWD_MIN_BLOCKS = 132
#: the most splits of a KV head's query heads: the block that adds their
#: partials reads splits - 1 of them, and past 8 that costs more than the
#: blocks gain (``tools/kernel_timing.py --bwd-splits``; ``PERF.md``)
BWD_MAX_SPLITS = 8
#: log2(e): the row statistic is in base 2 of the scaled logits
LOG2E = 1.4426950408889634
#: the mask value of the reference (``flash_attn/kernel.py``, ``ref.py``)
NEG_INF = -2.0e38
#: dtype -> (route, C launch function, source under ``repro_torch/csrc``)
ROUTES = {torch.bfloat16: ("tensor_core", "flash_attn_tc_launch",
                           "flash_attn_tc.cu"),
          torch.float32: ("cuda_core", "flash_attn_launch", "flash_attn.cu")}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, scale: float | None = None,
                          window: int | None = None,
                          causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """The materialized softmax of ``repro/kernels/flash_attn/ref.py``: the
    float32 logits ``(q·kᵀ)·scale`` [B, H, Sq, Sk] (scale 1/√Dqk by
    default), causal mask to ``-2e38`` (key j of query i when j <=
    ``q_offset`` + i, and j > ``q_offset`` + i - ``window`` when a window is
    given, as the reference's ``_sdpa`` masks them; no mask with
    ``causal=False``), softmax, ``·v`` [B, Sq, K, Dv], cast to ``q``'s
    dtype. K/V heads are repeated to H."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    return _plain_f32(q, k, v, scale, window, causal,
                      q_offset)[0].to(q.dtype)


def _plain_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, window: int | None, causal: bool,
               q_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_plain` before its cast ([B, Sq, H, Dv]
    float32) and its masked logits [B, H, Sq, Sk]."""
    group = q.shape[2] // k.shape[2]
    logits = _masked_logits(q, k, scale, window, causal, q_offset)[2]
    vf = v.repeat_interleave(group, dim=2).float().transpose(1, 2)
    out = torch.matmul(torch.softmax(logits, dim=-1), vf)
    return out.transpose(1, 2), logits


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, causal: bool, q_offset: int = 0) -> None:
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
    B, Sq, H, dqk = q.shape
    Sk = k.shape[1]
    if k.shape[:3] != v.shape[:3] or k.shape[0] != B or Sq > Sk or \
            k.shape[3] != dqk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)} disagree")
    if not isinstance(q_offset, int) or isinstance(q_offset, bool) or \
            q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be an int >= 0, "
                         f"got {q_offset!r}")
    if causal and q_offset + Sq > Sk:
        raise ValueError(f"flash_attention: a query shard of {Sq} rows at "
                         f"offset {q_offset} reaches past the {Sk} keys")
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


def _is_shard(q: torch.Tensor, k: torch.Tensor, q_offset: int) -> bool:
    """Whether a call's queries are a shard of its keys' sequence."""
    return q.shape[1] != k.shape[1] or q_offset != 0


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            window: int | None, causal: bool, q_offset: int = 0,
            lse: torch.Tensor | None = None,
            out_lo: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel of the inputs' dtype (``lse`` and ``out_lo``, the
    training forward's outputs: bf16 only)."""
    global launches
    B, Sq, H, dqk = q.shape
    Sk, dv = k.shape[1], v.shape[3]
    out = q.new_empty((B, Sq, H, dv))
    if B == 0 or Sq == 0:
        return out
    if any(t.data_ptr() % 16 for t in (q, k, v) + (
            () if out_lo is None else (out_lo,))):
        raise ValueError("flash_attention: kernel inputs must be 16-byte "
                         "aligned")
    route, fn, _ = ROUTES[q.dtype]
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    if q.dtype == torch.bfloat16:  # the tensor-core entry takes lse, out_lo
        ptrs += [None if t is None else t.data_ptr() for t in (lse, out_lo)]
    err = getattr(build.library(), fn)(
        *ptrs, B, Sq, Sk, q_offset, H, k.shape[2], dqk, dv, window or 0,
        int(causal), scale, build.stream_ptr(q))
    build.check(err, f"flash_attn ({route})")
    with COUNT_LOCK:
        launches += 1
        route_launches[route] += 1
        class_launches["query_shard" if _is_shard(q, k, q_offset) else
                       "causal" if causal else "noncausal"] += 1
    return out


def _mask_class(window: int | None, causal: bool) -> str:
    """The key of ``bwd_class_launches`` for a call's mask."""
    return "noncausal" if not causal else "window" if window else "causal"


def _check_backward(q: torch.Tensor) -> None:
    """Raise ``NotImplementedError`` for inputs the backward kernel does
    not take: it takes bf16 (at every pair of ``HEAD_DIMS``, which
    :func:`_check` has checked, and under every mask)."""
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"flash_attention: the backward kernel does not take {q.dtype} "
            "inputs (it takes bf16); ROADMAP queue 2 lists the kernels")


class _Attention(torch.autograd.Function):
    """bf16 K5 with its backward kernel, under any mask (see the module
    docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, causal, q_offset):
        out, lse, out_lo = flash_attention_lse(q, k, v, scale, window, causal,
                                               q_offset)
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        ctx.mask = (scale, window, causal)
        ctx.q_offset = q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, out_lo = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse,
                                              dout.contiguous(), *ctx.mask,
                                              out_lo=out_lo,
                                              q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, window: int | None = None,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Causal attention (over the last ``window`` keys when given), or
    bidirectional with ``causal=False``, of queries at positions
    ``q_offset + arange(Sq)`` over keys at ``arange(Sk)``; ``[B, Sq, H,
    Dv]`` out; see the module docstring. A CUDA call that needs a gradient
    runs the backward kernel or raises."""
    causal = bool(causal)
    _check(q, k, v, window, causal, q_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, scale, window, causal, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _check_backward(q)
        return _Attention.apply(q, k, v, scale, window, causal, q_offset)
    return _launch(q, k, v, scale, window, causal, q_offset)


def _masked_logits(q: torch.Tensor, k: torch.Tensor, scale: float,
                   window: int | None, causal: bool, q_offset: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q [B, H, Sq, Dqk] float32, k repeated to H heads [B, H, Sk, Dqk]
    float32, the logits ``q·kᵀ·scale`` [B, H, Sq, Sk] with
    :func:`flash_attention_plain`'s mask at ``NEG_INF``: query i at
    position ``q_offset`` + i): the plain row statistic's and backward's
    common part."""
    Sq, Sk = q.shape[1], k.shape[1]
    group = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.repeat_interleave(group, dim=2).float().transpose(1, 2)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        ones = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        mask = ones.tril(q_offset)
        if window:
            mask &= ~ones.tril(q_offset - window)
        logits = torch.where(mask, logits, NEG_INF)
    return qf, kf, logits


def flash_attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, scale: float | None = None,
                              window: int | None = None, causal: bool = True,
                              q_offset: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """:func:`flash_attention_plain`, each row's statistic
    ``logsumexp(q·kᵀ·scale)·log2(e)`` [B, H, Sq] float32 (the mask applied)
    and the output's low part: the float32 output less the output, in the
    inputs' dtype (0 for float32)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    out32, logits = _plain_f32(q, k, v, scale, window, causal, q_offset)
    out = out32.to(q.dtype)
    return (out, torch.logsumexp(logits, dim=-1) * LOG2E,
            (out32 - out.float()).to(q.dtype))


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None,
                        window: int | None = None, causal: bool = True,
                        q_offset: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention under :func:`flash_attention`'s mask (queries at
    ``q_offset + arange(Sq)``), its row statistic ``lse`` [B, H, Sq]
    float32, the log2-sum-exp2 of each row's scaled
    logits (``P = exp2(q·k·scale·log2(e) - lse)``), which the backward
    rebuilds the softmax from, and the output's low part ``out_lo`` (the
    float32 output less ``out``, rounded to bf16: ``out + out_lo`` holds
    it to ~16 bits, from which the backward takes D = rowsum(dO∘O)).
    CUDA: the bf16 kernel, one launch; CPU:
    :func:`flash_attention_lse_plain`."""
    causal = bool(causal)
    _check(q, k, v, window, causal, q_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if on_cpu(q, k, v):
        return flash_attention_lse_plain(q, k, v, scale, window, causal,
                                         q_offset)
    if q.dtype != torch.bfloat16:
        raise NotImplementedError("flash_attention_lse: the row statistic "
                                  "comes from the bf16 kernel only")
    B, Sq, H, _ = q.shape
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    out_lo = q.new_empty((B, Sq, H, v.shape[3]))
    return (_launch(q, k, v, scale, window, causal, q_offset, lse, out_lo),
            lse, out_lo)


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, dout: torch.Tensor,
                                   scale: float | None = None,
                                   window: int | None = None,
                                   causal: bool = True, q_offset: int = 0
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """The gradient of :func:`flash_attention_plain` (``ref.py``'s
    materialized float32 softmax, under the same mask: causal, causal over
    the last ``window`` keys, or none with ``causal=False``; queries at
    ``q_offset + arange(Sq)``) for the output gradient ``dout``: with K/V
    repeated to H heads, P = softmax(mask(q·kᵀ·scale)), dP = dout·vᵀ, dS =
    P ∘ (dP − rowsum(P ∘ dP)), dq = scale·dS·k, dk = scale·dSᵀ·q, dv =
    Pᵀ·dout, in float32; dk and dv then summed over each KV head's H/K query
    heads. Returns (dq [B, Sq, ..], dk, dv [B, Sk, ..]) in the inputs'
    dtypes."""
    B, Sq, H, dqk = q.shape
    K, Sk = k.shape[2], k.shape[1]
    group = H // K
    if scale is None:
        scale = 1.0 / math.sqrt(dqk)
    qf, kf, logits = _masked_logits(q, k, scale, window, causal, q_offset)
    vf = v.repeat_interleave(group, dim=2).float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)                 # [B, H, S, Dv]
    p = torch.softmax(logits, dim=-1)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof)

    def heads_summed(t):                               # [B, H, Sk, D] -> [B, Sk, K, D]
        return t.view(B, K, group, Sk, t.shape[-1]).sum(2).transpose(1, 2)

    return (dq.transpose(1, 2).to(q.dtype), heads_summed(dk).to(k.dtype),
            heads_summed(dv).to(v.dtype))


def bwd_plan(B: int, S: int, H: int, K: int, dqk: int, dv: int,
             splits: int | None = None) -> dict:
    """The backward kernel's plan at a shape (``csrc/flash_attn_bwd.cu``
    mirrors it), for ``S`` keys (a query shard's plan is its keys': the
    queries enter no part of it): ``key_rows`` keys a dK/dV block, the
    ``key_tiles`` of S,
    and ``splits``: the smallest divisor of the group G = H/K, at most
    ``BWD_MAX_SPLITS``, that gives at least ``BWD_MIN_BLOCKS`` dK/dV blocks
    (the largest such divisor when none does). A block sums its G/splits
    query heads in registers; with ``splits`` > 1 each writes
    float32 partials [splits, B, S, K, Dqk + Dv] (``partial_bytes``), and
    the last of a (key tile, b, KV head)'s blocks, found by an int ticket
    (``tickets``), adds them in split order. From the shape alone, so a
    shape always sums in the same order. ``splits`` given (a divisor of G)
    replaces that choice: ``tools/kernel_timing.py --bwd-splits`` times
    each."""
    key_rows = 64
    key_tiles = -(-S // key_rows)
    group = H // K
    blocks = key_tiles * B * K
    if splits is None:
        divisors = [d for d in range(1, min(group, BWD_MAX_SPLITS) + 1)
                    if group % d == 0]
        splits = next((d for d in divisors if blocks * d >= BWD_MIN_BLOCKS),
                      divisors[-1])
    elif group % splits:
        raise ValueError(f"bwd_plan: {splits} splits do not divide the "
                         f"group of {group} query heads")
    return dict(key_rows=key_rows, key_tiles=key_tiles, splits=splits,
                blocks=blocks * splits, tickets=blocks if splits > 1 else 0,
                partial_bytes=4 * splits * B * S * K * (dqk + dv)
                if splits > 1 else 0)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             scale: float | None = None,
                             window: int | None = None, causal: bool = True,
                             out_lo: torch.Tensor | None = None,
                             q_offset: int = 0
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dq, dk, dv) of attention under :func:`flash_attention`'s mask
    (causal, causal over the last ``window`` keys, or none with
    ``causal=False``; queries at ``q_offset + arange(Sq)``), given the
    forward's ``out``, ``lse`` and ``out_lo`` (:func:`flash_attention_lse`
    under the same mask; ``out_lo`` is needed on CUDA) and the output's
    gradient ``dout`` [B, Sq, H, Dv]; dk and dv cover all Sk keys (0 for a
    key no query row sees). CUDA:
    ``csrc/flash_attn_bwd.cu`` (bf16, ``BWD_HEAD_DIMS``, the mask as
    run-time arguments; two kernel launches; each KV head's query heads
    summed in a fixed order, :func:`bwd_plan`; no float atomics), one count
    in ``bwd_launches``; CPU: :func:`flash_attention_backward_plain`
    (``out``, ``lse`` and ``out_lo`` unused)."""
    global bwd_launches
    causal = bool(causal)
    _check(q, k, v, window, causal, q_offset)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if on_cpu(q, k, v, out, lse, dout):
        return flash_attention_backward_plain(q, k, v, dout, scale, window,
                                              causal, q_offset)
    _check_backward(q)
    B, Sq, H, dqk = q.shape
    Sk, K, dv = k.shape[1], k.shape[2], v.shape[3]
    if out.shape != (B, Sq, H, dv) or dout.shape != out.shape or \
            out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: out {tuple(out.shape)} "
                         f"{out.dtype} and dout {tuple(dout.shape)} "
                         f"{dout.dtype} must be [{B}, {Sq}, {H}, {dv}] "
                         f"{q.dtype}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse must be float32 "
                         f"[{B}, {H}, {Sq}], got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if out_lo is None or out_lo.shape != out.shape or \
            out_lo.dtype != out.dtype:
        raise ValueError("flash_attention_backward: out_lo, the forward's "
                         "output's low part (flash_attention_lse), must be "
                         f"{out.dtype} {tuple(out.shape)}")
    dq, dk, dvv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or Sq == 0:
        return dq, dk.zero_(), dvv.zero_()
    plan = bwd_plan(B, Sk, H, K, dqk, dv)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    part = torch.empty((plan["partial_bytes"] // 4,), dtype=torch.float32,
                       device=q.device)             # the splits' partials
    tickets = torch.empty((plan["tickets"],), dtype=torch.int32,
                          device=q.device)          # zeroed by the dQ kernel
    tensors = (q, k, v, out, out_lo, dout, lse, dq, dk, dvv, delta, part,
               tickets)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention_backward: kernel tensors must be "
                         "16-byte aligned")
    err = build.library().flash_attn_bwd_launch(
        *(t.data_ptr() or None for t in tensors), B, Sq, Sk, q_offset, H, K,
        dqk, dv, window or 0, int(causal), plan["splits"], scale,
        build.stream_ptr(q))
    build.check(err, "flash_attn backward")
    with COUNT_LOCK:
        bwd_launches += 1
        bwd_head_dim_launches[(dqk, dv)] = \
            bwd_head_dim_launches.get((dqk, dv), 0) + 1
        bwd_class_launches["query_shard" if _is_shard(q, k, q_offset) else
                           _mask_class(window, causal)] += 1
    return dq, dk, dvv
