"""Attention for every family, ``repro.models.attention`` on PyTorch:
grouped-query attention (GQA, with qk-norm, rotary embeddings, in
recurrentgemma-9b a sliding window over a ring cache, and in whisper-tiny
bidirectional without rope) and multi-head latent attention (MLA,
DeepSeek's, as minicpm3-4b runs it).

Dispatch follows the port's device rule:

- On a CPU tensor everything runs the plain ``_sdpa`` (the reference's
  flash-style attention, including its online-softmax chunk path at
  Sk >= 4096), whatever the mask.
- On a CUDA tensor, causal prefill with positions ``arange(S)`` runs kernel
  K5 (:func:`repro_torch.kernels.flash_attn.flash_attention`), reading KV
  head h // (H/K) in place of the repeat, with the config's sliding window
  when it has one (the mask of ``_sdpa``: key j is seen by query i when
  j <= i and j > i - window). Bidirectional prefill (``causal=False``, the
  whisper encoder) runs K5 with ``causal=False`` and no window, whatever
  the positions: without the causal mask they do not enter it.
- Single-query decode (``Sq == 1`` with the ``valid_to`` mask) runs as plain
  torch ops on both devices: the reference computes it outside any kernel.
  With a window the decode cache is a ring of ``window`` slots (position p
  at slot p % window, every slot below min(p + 1, window) valid), as the
  reference's ``gqa_apply`` keeps it. MLA's decode is the reference's
  absorbed form over the latent cache (q_nope folded through W_uk, W_uv
  applied after the weighted latent sum), also plain torch on both devices.
- MLA's prefill is un-absorbed, as in the reference: q·k over the nope +
  rope dims (the rope key broadcast to every head), v at its own width,
  scale 1/√(nope + rope). On CUDA it runs K5 with those unequal head dims;
  when nope + rope is not a multiple of 16 (the smoke dims, 24) q and k are
  zero-padded to the next one (also for an ``attention=`` function on the
  CPU), which leaves every q·k unchanged.
- A query shard of a sequence-parallel prefill or training step (q of Sq
  positions against all Sk keys, under a mesh that splits q's sequence)
  runs K5 with ``q_offset``, the shard's first position, read from the
  mesh coordinate (:func:`_sharded_prefill_attention`); its backward runs
  K5's backward with the same offset.
- Causal prefill at other positions on CUDA raises
  ``NotImplementedError``; it never drops to the plain version.
- Cross-attention (the whisper decoder's queries over the encoder's K/V,
  Sq ≠ Sk) is not here: :mod:`.model` runs it as plain ``_sdpa`` on both
  devices, as the reference computes it outside any kernel.

Only ``attention=`` changes what prefill runs: a function with K5's
signature (``q`` [B,S,H,Dqk], ``k`` [B,S,K,Dqk], ``v`` [B,S,K,Dv],
``scale=``, ``window=`` when the config has a window, ``causal=False``
for a bidirectional layer and ``q_offset=`` for a query shard) used in its
place, encoder and decoder alike, as the tests and ``chip_smoke.py`` pass
K5's plain version to compare.

The decode cache is written in place (the reference's ``_scatter_time``
returns a new array with the same values).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels import flash_attn
from repro_torch.parallel.sharding import (P, constraint, current_rules,
                                          from_local, is_sharded,
                                          local_shape_offset, redistribute)
from .layers import (dense_init_, linear, param, rms_norm, rms_norm_init_,
                     rope)

__all__ = ["GQAttention", "gqa_apply", "KVCache", "init_kv_cache",
           "MLAttention", "mla_apply", "MLACache", "init_mla_cache",
           "NEG_INF"]

NEG_INF = -2.0e38

#: K5's signature: (q, k, v, scale=...) -> out
Attention = Callable[..., torch.Tensor]


class KVCache(NamedTuple):
    k: torch.Tensor   # [B, S_cache, K, hd] (a model's cache: [L, B, S_cache, K, hd])
    v: torch.Tensor


class MLACache(NamedTuple):
    latent: torch.Tensor  # [B, S_cache, kv_lora] (a model's: [L, B, ...])
    k_rope: torch.Tensor  # [B, S_cache, qk_rope]


#: the logical axes of one layer's caches (``init_kv_cache``'s and
#: ``init_mla_cache``'s), and of a decoder layer's cross K/V over the
#: encoder's positions (``init_cache``'s ``cross``)
_KV = ("batch", "cache_seq", "kv_heads", None)
KV_CACHE_AXES = KVCache(_KV, _KV)
_LAT = ("batch", "cache_seq", None)
MLA_CACHE_AXES = MLACache(_LAT, _LAT)
_XKV = ("batch", None, "kv_heads", None)
CROSS_CACHE_AXES = KVCache(_XKV, _XKV)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: {what} is not yet ported to CUDA: K5's causal mask "
        "takes queries at q_offset + arange(Sq) over keys at arange(Sk)")


class GQAttention(torch.nn.Module):
    """The parameters of ``gqa_init``: ``wq`` [d, H, hd], ``wk``/``wv``
    [d, K, hd], ``wo`` [H, hd, d] in bf16 and, with ``qk_norm``, ``q_norm``/
    ``k_norm`` [hd] in float32."""

    #: each parameter's logical axes (``gqa_init``'s)
    AXES = {"wq": ("embed_fsdp", "heads", "head_dim"),
            "wk": ("embed_fsdp", "kv_heads", "head_dim"),
            "wv": ("embed_fsdp", "kv_heads", "head_dim"),
            "wo": ("heads", "head_dim", "embed_fsdp"),
            "q_norm": (None,), "k_norm": (None,)}

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.cfg = cfg
        self.wq = param((d, H, hd), device)
        self.wk = param((d, K, hd), device)
        self.wv = param((d, K, hd), device)
        self.wo = param((H, hd, d), device)
        self.q_norm = param((hd,), device, torch.float32) if cfg.qk_norm \
            else None
        self.k_norm = param((hd,), device, torch.float32) if cfg.qk_norm \
            else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            dense_init_(w, generator)
        for w in (self.q_norm, self.k_norm):
            if w is not None:
                rms_norm_init_(w)

    def forward(self, x, positions, cache=None, cache_pos=None, *,
                causal: bool = True, use_rope: bool = True,
                attention: Optional[Attention] = None):
        return gqa_apply(self, self.cfg, x, positions, cache, cache_pos,
                         causal, use_rope, attention=attention)


def _pick_chunk(sk: int, target: int = 1024, threshold: int = 4096) -> int:
    """Largest k-chunk <= ~target that divides Sk; 0 = don't chunk."""
    if sk < threshold:
        return 0
    n = -(-sk // target)  # ceil
    while sk % n:
        n += 1
    c = sk // n
    return c if c < sk else 0


def _sdpa(q, k, v, scale, qpos=None, kpos=None, causal=True, window=None,
          valid_to=None):
    """The reference's attention (``repro.models.attention._sdpa``), plain.

    q [B,Sq,H,hd]; k [B,Sk,H,hd]; v [B,Sk,H,hdv] (GQA callers repeat k/v to
    H heads first). Float32 logits of ``q·scale`` against k; from Sk = 4096
    (never for a single query) the keys go in chunks with a running max and
    sum. Masks: ``causal`` uses qpos/kpos [B,Sq]/[B,Sk]; ``window`` adds a
    sliding-window bound; ``valid_to`` [B] masks cache slots past it.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    qf = q.float() * scale
    chunk = 0 if Sq == 1 else _pick_chunk(Sk)

    def block(kc, kposc):
        logits = torch.einsum("bqhd,bshd->bhqs", qf, kc.float())
        mask = None
        if causal and qpos is not None:
            mask = kposc[:, None, None, :] <= qpos[:, None, :, None]
            if window:
                mask &= kposc[:, None, None, :] > qpos[:, None, :, None] - window
        if valid_to is not None:
            vmask = kposc[:, None, None, :] <= valid_to[:, None, None, None]
            mask = vmask if mask is None else (mask & vmask)
        if mask is not None:
            logits = torch.where(mask, logits, NEG_INF)
        return logits

    kposs = kpos if kpos is not None else \
        torch.arange(Sk, device=q.device).expand(B, Sk)
    if not chunk:
        w = torch.softmax(block(k, kposs), dim=-1)
        out = torch.einsum("bhqs,bshd->bqhd", w, v.float())
        return out.to(q.dtype)

    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=q.device)
    s = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, Sk, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        logits = block(kc, kposs[:, c0:c0 + chunk])            # [B,H,Sq,C]
        new_m = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - new_m)
        pe = torch.exp(logits - new_m[..., None])
        s = s * alpha + pe.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqs,bshd->bhqd", pe, vc.float())
        m = new_m
    out = acc / torch.clamp(s, min=1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)                     # [B,Sq,H,hdv]


def _repeat_kv(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,K,hd] -> [B,S,H,hd] by repeating each kv head H/K times (a
    DTensor by a broadcast and a reshape, which DTensor shards)."""
    K = t.shape[2]
    if K == n_heads:
        return t
    if is_sharded(t):
        B, S, _, hd = t.shape
        return t[:, :, :, None].expand(B, S, K, n_heads // K, hd).reshape(
            B, S, n_heads, hd)
    return t.repeat_interleave(n_heads // K, dim=2)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    B, S, d = x.shape
    return linear(x, w.to(x.dtype).reshape(d, -1)).view(B, S, *w.shape[1:])


def _tokens_at(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, n] -> [B, S, n]."""
    return linear(x, w.to(x.dtype))


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """[B, S, H, dv] @ wo [H, dv, d] -> [B, S, d] (a DTensor's heads as a
    split contraction: a partial sum over them)."""
    B, S, H, dv = out.shape
    return linear(out.reshape(B, S, H * dv),
                  wo.to(out.dtype).reshape(H * dv, -1))


def _prefill_attention(q, k, v, positions, cfg, causal: bool, scale: float,
                       attention: Optional[Attention], from_zero: bool,
                       kpos: Optional[torch.Tensor] = None,
                       q_offset: int = 0) -> torch.Tensor:
    """Prefill attention of q [B, Sq, H, Dqk] at ``positions`` [B, Sq] over
    k [B, Sk, K, Dqk], v [B, Sk, K, Dv] at ``kpos`` (default:
    ``positions``); DTensors go shard by shard
    (:func:`_sharded_prefill_attention`). A query shard (Sq < Sk) sits at
    positions ``q_offset + arange(Sq)`` over keys at ``arange(Sk)`` where K5
    or an ``attention`` function runs it."""
    if is_sharded(q):
        return _sharded_prefill_attention(q, k, v, positions, cfg, causal,
                                          scale, attention, from_zero)
    H = q.shape[2]
    kpos = positions if kpos is None else kpos
    if attention is None and q.device.type == "cpu":
        return _sdpa(q, _repeat_kv(k, H), _repeat_kv(v, H), scale,
                     qpos=positions, kpos=kpos, causal=causal,
                     window=cfg.window)
    B, S = q.shape[:2]
    Sk = k.shape[1]
    # the kernel's causal mask is over positions q_offset + arange(S) and
    # keys at arange(Sk): given positions are checked on the device (a
    # synchronize); the model's prefill passes None, so its layers (and
    # their query shards) check nothing. A bidirectional call's mask does
    # not depend on them (and _sdpa applies a window only under causal).
    if causal and not from_zero and not (
            torch.equal(positions, q_offset + torch.arange(
                S, dtype=positions.dtype, device=positions.device
            ).expand(B, S)) and torch.equal(kpos, torch.arange(
                Sk, dtype=kpos.dtype, device=kpos.device).expand(B, Sk))):
        raise _not_ported("prefill at positions other than arange(S)")
    if not causal:
        kw = {"causal": False}
    else:
        kw = {"window": cfg.window} if cfg.window else {}
    if Sk != S:  # a query shard of a sequence-parallel prefill
        kw["q_offset"] = q_offset
    return (attention or flash_attn.flash_attention)(q, k, v, scale=scale,
                                                     **kw)


def _sharded_prefill_attention(q, k, v, positions, cfg, causal, scale,
                               attention, from_zero):
    """Prefill attention on DTensors: q at the reference's ("batch", "seq",
    "heads", None), k/v at ("batch", None, "kv_heads", None) (repeated to H
    heads first where the heads shard and the KV heads cannot, so each
    rank's query heads meet their own KV heads), then each rank's shards
    through :func:`_prefill_attention` (the CPU's ``_sdpa``, K5 on CUDA)
    with its queries' positions against every key's, the way
    ``local_map`` runs a function on local shards, with k/v's gradient
    placed by hand (a partial sum where q is split and k/v are not). Where
    q's sequence is split (sequence parallelism) the rank's first query
    position, its shard's offset on dim 1 from the mesh coordinate (no
    host sync), is K5's ``q_offset``, forward and backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    r = current_rules()
    mesh = q.device_mesh
    H = q.shape[2]
    qa = ("batch", "seq", "heads", None)
    q_spec = r.spec(qa, q.shape)
    kva = ("batch", None, "kv_heads", None)
    head_of = lambda spec: spec[2] if len(spec) > 2 else None  # noqa: E731
    if head_of(r.spec(kva, k.shape)) != head_of(q_spec):
        if head_of(q_spec) is None:
            kva = ("batch", None, None, None)
        else:
            k, v = _repeat_kv(k, H), _repeat_kv(v, H)
            kva = ("batch", None, "heads", None)
    q = constraint(q, *qa)
    k = constraint(k, *kva)
    v = constraint(v, *kva)
    if not is_sharded(positions):
        positions = DTensor.from_local(positions, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
    qpos = redistribute(positions, P(*r.spec(qa, q.shape)[:2]))
    kpos = redistribute(positions, P(*r.spec(kva, k.shape)[:2]))

    pl = [list(t.placements) for t in (q, k, v)]
    # where q is split and k/v are whole (sequence parallelism), a rank's
    # k/v gradient comes from its own queries only: a partial sum
    kv_grad = [Partial() if a != Replicate() and b == Replicate() else b
               for a, b in zip(pl[0], pl[1])]
    q_offset = local_shape_offset(q.shape, mesh, q.placements)[1][1]
    out = _prefill_attention(
        q.to_local(), k.to_local(grad_placements=kv_grad),
        v.to_local(grad_placements=kv_grad), qpos.to_local(), cfg, causal,
        scale, attention, from_zero, kpos=kpos.to_local(), q_offset=q_offset)
    return from_local(out, mesh, pl[0],
                      shape=tuple(q.shape[:3]) + (v.shape[-1],))


def gqa_apply(p, cfg, x: torch.Tensor, positions: Optional[torch.Tensor],
              cache: Optional[KVCache] = None,
              cache_pos: Optional[int] = None, causal: bool = True,
              use_rope: bool = True, *,
              attention: Optional[Attention] = None,
              ) -> tuple[torch.Tensor, Optional[KVCache]]:
    """x [B, S, d] at ``positions`` [B, S] (None: a prefill at positions
    arange(S), as the model's prefill runs it); prefill when ``cache`` is
    None (causal, or bidirectional with ``causal=False``; returns the
    layer's KVCache when ``cache_pos`` is given), else one-step decode
    (S == 1) writing k/v into ``cache`` in place at slot ``cache_pos`` (slot
    ``cache_pos % window`` of a ring when the config has a sliding window).
    ``causal=False`` and ``use_rope=False`` serve the whisper encoder
    (bidirectional, absolute positions); its decoder runs without rope."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    from_zero = positions is None
    if from_zero:
        if cache is not None:
            raise ValueError("gqa_apply: a decode step needs its positions")
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    q = _heads(x, p.wq)
    k = _heads(x, p.wk)
    v = _heads(x, p.wv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    scale = 1.0 / math.sqrt(hd)

    if cache is None:  # prefill: causal (+ window) mask, or none
        out = _prefill_attention(q, k, v, positions, cfg, causal, scale,
                                 attention, from_zero)
        new_cache = KVCache(k, v) if cache_pos is not None else None
    else:  # decode: S == 1
        if S != 1:
            raise ValueError(f"gqa_apply: decode takes one token, got S={S}")
        pos = int(cache_pos)
        slot = pos % cfg.window if cfg.window else pos
        _write_slot(cache.k, k[:, 0], slot)
        _write_slot(cache.v, v[:, 0], slot)
        # a ring keeps every slot below min(pos + 1, window) valid
        valid_to = min(pos, cfg.window - 1) if cfg.window else pos
        if is_sharded(cache.k):
            out = _sharded_decode(_gqa_decode_part, scale, valid_to,
                                  (q,), (cache.k, cache.v)).to(q.dtype)
        else:
            out = _sdpa(q, _repeat_kv(cache.k, H), _repeat_kv(cache.v, H),
                        scale, causal=False,
                        valid_to=torch.full((B,), valid_to, device=x.device))
        new_cache = cache
    return _out_proj(out, p.wo), new_cache


def init_kv_cache(cfg, batch: int, length: int, dtype=torch.bfloat16,
                  device=None, n_layers: Optional[int] = None) -> KVCache:
    """A zeroed cache [B, S, K, hd], or [n_layers, B, S, K, hd] (a model's,
    its layers stacked as the reference's ``init_cache`` stacks them)."""
    L = min(length, cfg.window) if cfg.window else length
    shape = (batch, L, cfg.n_kv_heads, cfg.head_dim)
    if n_layers is not None:
        shape = (n_layers,) + shape
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


# ------------------------------------------------------------------ MLA
class MLAttention(torch.nn.Module):
    """The parameters of ``mla_init``: ``wq_a`` [d, q_lora] and ``wq_b``
    [q_lora, H, nope + rope] (``wq`` [d, H, nope + rope] when ``q_lora`` is
    0), ``wkv_a`` [d, kv_lora + rope], ``wkv_b`` [kv_lora, H, nope + v],
    ``wo`` [H, v, d] in bf16 and ``kv_norm`` [kv_lora] in float32."""

    #: each parameter's logical axes (``mla_init``'s)
    AXES = {"wq_a": ("embed_fsdp", None), "wq_b": (None, "heads", None),
            "wq": ("embed_fsdp", "heads", None),
            "wkv_a": ("embed_fsdp", None), "wkv_b": (None, "heads", None),
            "wo": ("heads", None, "embed_fsdp"), "kv_norm": (None,)}

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        qd = cfg.qk_nope_dim + cfg.qk_rope_dim
        self.cfg = cfg
        if cfg.q_lora:
            self.wq_a = param((d, cfg.q_lora), device)
            self.wq_b = param((cfg.q_lora, H, qd), device)
            self.wq = None
        else:
            self.wq_a = self.wq_b = None
            self.wq = param((d, H, qd), device)
        self.wkv_a = param((d, cfg.kv_lora + cfg.qk_rope_dim), device)
        self.wkv_b = param((cfg.kv_lora, H, cfg.qk_nope_dim + cfg.v_head_dim),
                           device)
        self.wo = param((H, cfg.v_head_dim, d), device)
        self.kv_norm = param((cfg.kv_lora,), device, torch.float32)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq_a, self.wq_b, self.wq, self.wkv_a, self.wkv_b,
                  self.wo):
            if w is not None:
                dense_init_(w, generator)
        rms_norm_init_(self.kv_norm)

    def forward(self, x, positions, cache=None, cache_pos=None, *,
                attention: Optional[Attention] = None):
        return mla_apply(self, self.cfg, x, positions, cache, cache_pos,
                         attention=attention)


def _mla_q(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """(q_nope [B,S,H,nope], q_rope [B,S,H,rope] rotated)."""
    if cfg.q_lora:
        q = _heads(_tokens_at(x, p.wq_a), p.wq_b)
    else:
        q = _heads(x, p.wq)
    q_nope = q[..., : cfg.qk_nope_dim]
    q_rope = rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    return q_nope, q_rope


def mla_apply(p, cfg, x: torch.Tensor, positions: Optional[torch.Tensor],
              cache: Optional[MLACache] = None,
              cache_pos: Optional[int] = None, *,
              attention: Optional[Attention] = None,
              ) -> tuple[torch.Tensor, Optional[MLACache]]:
    """``repro.models.attention.mla_apply``: x [B, S, d] at ``positions``
    [B, S] (None: a prefill at arange(S)). Prefill when ``cache`` is None
    (causal, un-absorbed; returns the layer's MLACache when ``cache_pos`` is
    given), else one absorbed decode step (S == 1) over the latent cache,
    written in place at slot ``cache_pos``."""
    B, S, _ = x.shape
    H, nope, rdim = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    dt = x.dtype
    from_zero = positions is None
    if from_zero:
        if cache is not None:
            raise ValueError("mla_apply: a decode step needs its positions")
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    scale = 1.0 / math.sqrt(nope + rdim)
    kv_a = _tokens_at(x, p.wkv_a)
    latent = rms_norm(kv_a[..., : cfg.kv_lora], p.kv_norm, cfg.norm_eps)
    k_rope = rope(kv_a[..., None, cfg.kv_lora:], positions,
                  cfg.rope_theta)[:, :, 0]
    q_nope, q_rope = _mla_q(p, cfg, x, positions)

    if cache is None:  # prefill: un-absorbed, causal
        # under a mesh the latent (kv_lora + rope a token) is gathered
        # before the per-head expansion, as the reference's constraints do
        latent = constraint(latent, "batch", None, None)
        k_rope = constraint(k_rope, "batch", None, None)
        kv = _heads(latent, p.wkv_b)                     # [B,S,H,nope+v]
        # K5 takes contiguous tensors: the concatenations are; v is copied
        # out of kv. Where K5 (or a function in its place) runs, zero
        # features pad q·k to a multiple of 16, the kernel's dims (not for
        # a function that takes any width: the dry run's)
        pad = []
        kernel_dims = x.device.type != "cpu" if attention is None else \
            not getattr(attention, "takes_any_head_dim", False)
        if kernel_dims and (nope + rdim) % 16:
            pad = [q_nope.new_zeros((B, S, H, -(nope + rdim) % 16))]
        q_cat = torch.cat([q_nope, q_rope] + pad, dim=-1)
        k_cat = torch.cat([kv[..., :nope],
                           k_rope[:, :, None, :].expand(B, S, H, rdim)] + pad,
                          dim=-1)
        v = kv[..., nope:].contiguous()
        out = _prefill_attention(q_cat, k_cat, v, positions, cfg, True,
                                 scale, attention, from_zero)
        new_cache = MLACache(latent, k_rope) if cache_pos is not None \
            else None
    else:  # decode: absorbed attention over the latent cache
        if S != 1:
            raise ValueError(f"mla_apply: decode takes one token, got S={S}")
        pos = int(cache_pos)
        _write_slot(cache.latent, latent[:, 0], pos)
        _write_slot(cache.k_rope, k_rope[:, 0], pos)
        w_uk = p.wkv_b.to(dt)[..., :nope]                # [r, H, nope]
        q_eff = torch.einsum("bqhk,rhk->bqhr", q_nope, w_uk)
        if is_sharded(cache.latent):
            lat_sum = _sharded_decode(_mla_decode_part, scale, pos,
                                      (q_eff, q_rope),
                                      (cache.latent, cache.k_rope))
        else:
            lat = cache.latent.float()                   # [B, Sc, r]
            logits = (torch.einsum("bqhr,bsr->bhqs", q_eff.float(), lat)
                      + torch.einsum("bqhk,bsk->bhqs", q_rope.float(),
                                     cache.k_rope.float())) * scale
            valid = torch.arange(lat.shape[1], device=x.device) <= pos
            logits = torch.where(valid, logits, NEG_INF)
            w = torch.softmax(logits, dim=-1)
            lat_sum = torch.einsum("bhqs,bsr->bqhr", w, lat)
        w_uv = p.wkv_b.to(dt)[..., nope:]                # [r, H, v]
        out = torch.einsum("bqhr,rhv->bqhv", lat_sum.to(dt), w_uv)
        new_cache = cache
    return _out_proj(out, p.wo), new_cache


# ------------------------------------------------------- sharded decode
def _seq_offset(cache: torch.Tensor) -> int:
    """The first cache slot (dim 1) this rank holds."""
    return local_shape_offset(cache.shape, cache.device_mesh,
                              cache.placements)[1][1]


def _write_slot(cache: torch.Tensor, row: torch.Tensor, slot: int) -> None:
    """``cache[:, slot] = row`` in place. A DTensor cache sharded on its
    slots is written by the rank that holds ``slot`` alone, from ``row``
    at the cache's placements on the other dims."""
    if not is_sharded(cache):
        cache[:, slot] = row
        return
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if p == Shard(1) or not p.is_shard() else
          Shard(p.dim - (p.dim > 1)) for p in cache.placements]
    row = row.redistribute(cache.device_mesh, pl).to_local()
    local = cache.to_local()
    i = slot - _seq_offset(cache)
    if 0 <= i < local.shape[1]:
        local[:, i] = row


def _gqa_decode_part(q, k, v, kpos, valid_to, scale):
    """One rank's share of a decode step over its cache slots: (the row
    max [B, H, 1], the sum of exp [B, H, 1], the unnormalized output [B, 1,
    H, hd]) in float32, slots past ``valid_to`` masked."""
    H = q.shape[2]
    logits = torch.einsum("bqhd,bshd->bhqs", q.float() * scale,
                          _repeat_kv(k, H).float())
    logits = torch.where(kpos <= valid_to, logits, NEG_INF)
    m = logits.amax(dim=-1)
    pe = torch.exp(logits - m[..., None])
    acc = torch.einsum("bhqs,bshd->bqhd", pe, _repeat_kv(v, H).float())
    return m, pe.sum(-1), acc


def _mla_decode_part(q_eff, q_rope, lat, k_rope, kpos, valid_to, scale):
    """MLA's absorbed decode over this rank's latent slots, as
    :func:`_gqa_decode_part`; the output is the weighted latent sum."""
    latf = lat.float()
    logits = (torch.einsum("bqhr,bsr->bhqs", q_eff.float(), latf)
              + torch.einsum("bqhk,bsk->bhqs", q_rope.float(),
                             k_rope.float())) * scale
    logits = torch.where(kpos <= valid_to, logits, NEG_INF)
    m = logits.amax(dim=-1)
    pe = torch.exp(logits - m[..., None])
    return m, pe.sum(-1), torch.einsum("bhqs,bsr->bqhr", pe, latf)


def _sharded_decode(part, scale, valid_to, qs, caches):
    """A decode step's attention over a DTensor cache, split as the
    reference's flash-decoding: each rank scores its own slots (``part``),
    then the row max is all-reduced (max) over the mesh dims that split the
    slots, each rank's sum and output are rescaled to it and all-reduced
    (sum), and the output is their quotient. The queries take the cache's
    batch and head sharding (heads: KV heads' factor) and are whole over
    the slots' mesh dims. Returns [B, 1, H, ·] in float32 (the caller
    casts), sharded as the queries."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard
    c0 = caches[0]
    mesh = c0.device_mesh
    seq_dims = [i for i, p in enumerate(c0.placements) if p == Shard(1)]
    q_pl = [Shard(0) if p == Shard(0) else Shard(2) if p == Shard(2)
            else Replicate() for p in c0.placements]
    loc_q = [q.redistribute(mesh, q_pl).to_local() if is_sharded(q) else q
             for q in qs]
    loc_c = [c.to_local() for c in caches]
    n = loc_c[0].shape[1]
    kpos = torch.arange(n, device=loc_c[0].device) + _seq_offset(c0)
    m, s, acc = part(*loc_q, *loc_c, kpos, valid_to, scale)
    for d in seq_dims:
        m_all = funcol.all_reduce(m, "max", (mesh, d))
        m, w = m_all, torch.exp(m - m_all)
        s = s * w
        acc = acc * w.transpose(1, 2)[..., None]
        s = funcol.all_reduce(s, "sum", (mesh, d))
        acc = funcol.all_reduce(acc, "sum", (mesh, d))
    out = acc / torch.clamp(s, min=1e-30).transpose(1, 2)[..., None]
    return from_local(out, mesh, q_pl, shape=tuple(qs[0].shape[:3]) + (
        out.shape[-1],))


def init_mla_cache(cfg, batch: int, length: int, dtype=torch.bfloat16,
                   device=None, n_layers: Optional[int] = None) -> MLACache:
    """A zeroed latent cache ([B, S, kv_lora], [B, S, rope]), or the layers
    stacked [n_layers, B, S, ...]."""
    lead = (batch, length) if n_layers is None else (n_layers, batch, length)
    return MLACache(
        torch.zeros(lead + (cfg.kv_lora,), dtype=dtype, device=device),
        torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dtype, device=device))
