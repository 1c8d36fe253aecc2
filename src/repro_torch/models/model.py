"""Model assembly for every family of the registry: ``ArchConfig`` -> an
``LM`` module and its ``prefill`` / ``decode_step`` / ``init_cache``.

A port of ``repro.models.model``. Each decoder block is one of five kinds
(``layer_kinds``), the reference's ``_plan``:

- ``attn_mlp``: pre-norm GQA or MLA attention, then a gated MLP (of
  ``dense_d_ff`` in the leading dense layers of an MoE config, deepseek's
  layer 0);
- ``attn_moe``: the same with a Mixture-of-Experts (:mod:`.moe`) in place
  of the MLP, at and past ``first_dense_layers`` of a config with experts;
- ``ssm``: pre-norm Mamba-2 (:mod:`.ssm`), every layer of the ``ssm``
  family (mamba2-370m);
- ``rglru``: pre-norm RG-LRU (:mod:`.rglru`), then a pre-norm gated MLP.
  The ``hybrid`` family (recurrentgemma-9b) runs groups of (``rglru``,
  ``rglru``, ``attn_mlp``) with ``attn_period`` 3, the remainder as the
  reference's ``tail_{i}`` blocks; its attention has a sliding window;
- ``dec``: the ``attn_mlp`` layout with a cross-attention sub-block
  (``lnx``, ``xattn``) between the attention and the MLP: every layer of
  the ``audio`` family (whisper-tiny), whose decoder runs without rope.

The ``audio`` family also has an encoder: ``enc_layers`` blocks of kind
``enc`` (the ``attn_mlp`` layout, bidirectional, no rope) over the
precomputed frame embeddings plus a float32 sinusoid (``_sinusoid``), then
``enc_ln``. The prefill computes each decoder layer's cross K/V from the
encoder's output once (``_enc_kv``); cross-attention is the reference's
``_sdpa`` without a mask, in plain torch on both devices (Sq ≠ Sk, outside
any kernel in the reference too). A config with ``max_pos`` adds learned
absolute positions (``pos_embed``) to the token embeddings. The ``vlm``
family (pixtral-12b) is the dense plan whose prompt's first
min(``n_patches``, S) slots take the given patch embeddings in place of
the tokens' (``images``).

The reference scans stacked layers (``layers.b{j}``) and keeps the others
outside its scan (``lead_{i}``, ``tail_{i}``); here ``_forward`` loops over
one ``nn.ModuleList`` of all blocks in layer order. The parameter layout is
the reference's ``init`` tree with the stacks split into one block per
layer (``reference_slot``): ``embed`` [V, d], ``head`` [d, V] (untied),
``final_ln`` [d], ``pos_embed`` [max_pos, d] (with ``max_pos``) and, per
block, ``ln1``, then ``attn.{wq,wk,wv,wo,q_norm,k_norm}`` (GQA) or
``attn.{wq_a,wq_b,wq,wkv_a,wkv_b,wo,kv_norm}`` (MLA), ``ln2``, ``lnx`` and
``xattn.{wq,wk,wv,wo}`` (``dec``) and ``mlp.{wg,wu,wd}`` or
``moe.{router,wg,wu,wd,shared}``; or
``ssm.{wz,wx,wbc,wdt,conv_w,A_log,D,dt_bias,norm,wo}``; or ``lru.{wx,wg,
conv_w,wa,wi,lam,wo}``, ``ln2`` and ``mlp``. The encoder's blocks are
``enc_layers`` (block g reads ``enc_layers.<leaf>[g]``) and ``enc_ln``
[d]. A tied head (mamba2) reads the embedding.

The compute dtype is bf16, as in the reference's ``_forward``. The decode
cache holds one stack for each kind of layer cache, its layers in layer
order, and each block reads its own index of its kind's stack:

- GQA: a :class:`~repro_torch.models.attention.KVCache` [L, B, S, K, hd];
  MLA: an :class:`~repro_torch.models.attention.MLACache` ([L, B, S,
  kv_lora], [L, B, S, rope]);
- SSM: an :class:`~repro_torch.models.ssm.SSMCache` ([L, B, W-1,
  conv_dim], [L, B, H, hd, N] float32);
- hybrid: a :class:`HybridCache` of the attention layers' ``KVCache``, a
  ring of min(length, window) slots, and the recurrent layers'
  :class:`~repro_torch.models.rglru.LRUCache` ([n, B, W-1, width], [n, B,
  width] float32);
- encoder-decoder: an :class:`EncDecCache` of the decoder's self-attention
  ``KVCache`` [L, B, S, K, hd] and the cross ``KVCache`` [L, B, enc_len,
  K, hd] the prefill computed (decode reads it and never writes it).

``decode_step`` writes the cache in place. The MoE layers' load-balancing
loss is computed and dropped, as the reference's serving drops it (the
loss keeps it). ``check_ported`` refuses a family outside the registry's.

Training: :func:`loss_fn` is the reference's ``loss_fn`` (inputs
``tokens[:, :-1]``, labels ``tokens[:, 1:]``, positions ``arange(S)``,
``ce + 0.01·aux``, aux the MoE layers' balance losses summed in layer
order; a vision config's patch slots, the first ``n_patches`` positions,
masked out of ``ce``; an encoder-decoder's ``frames`` encoded first) over
a trunk that builds no decode cache, with ``remat`` as non-reentrant
``torch.utils.checkpoint`` per decoder block (the reference's
``jax.checkpoint`` of each scanned layer; as there, an encoder's blocks
keep their activations). It differentiates with respect to whatever
parameters of the ``LM`` require a gradient; the serving parameters do not
(``prefill``/``decode_step`` run under ``no_grad``), and
``repro_torch.train`` keeps a compute copy that does. Every family of the
registry trains; :func:`check_ported` refuses the rest, on every device.

``routing=`` (``prefill``, ``decode_step``, ``loss_fn``) is a test hook
``(layer, probs, k) -> expert indices [T, k]``: ``moe.route``'s signature
after the index of the MoE layer whose expert choice it makes. Under
``remat`` a MoE layer's router runs again in the backward, in reverse
layer order, so a hook that records or replays choices keys them on the
layer, never on the order of its calls.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from . import attention as attn
from .moe import MoE, Routing
from .rglru import RGLRU, LRUCache, init_lru_cache
from .ssm import Mamba2, SSMCache, init_ssm_cache
from .layers import (GatedMLP, cross_entropy, embed, embedding_init_,
                     dense_init_, lm_head, normal_init_, param, rms_norm,
                     rms_norm_init_)

__all__ = ["LM", "Block", "HybridCache", "EncDecCache", "init", "prefill",
           "decode_step", "init_cache", "check_ported", "layer_kinds",
           "reference_slot", "loss_fn", "xent_chunks"]

#: the families the port runs: every family of the registry
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_ported(cfg, device: torch.device | str | None = None) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run; the
    same on every ``device`` (None means CUDA, the default)."""
    why = None
    if cfg.family not in FAMILIES:
        why = f"the {cfg.family} family"
    elif cfg.family != "ssm" and cfg.attn_kind not in ("gqa", "mla"):
        why = f"{cfg.attn_kind} attention"
    elif cfg.is_encdec and cfg.attn_kind != "gqa":
        why = f"an encoder-decoder with {cfg.attn_kind} attention"
    if why is not None:
        raise NotImplementedError(
            f"repro_torch: {why} ({cfg.arch_id}) is not yet ported "
            "(ROADMAP queue 1)")


def xent_chunks(cfg) -> int:
    """``repro.models.model.xent_chunks``: 1 when the vocab is a multiple of
    16, else the first of 8, 5, 4, 10, 7, 3, 2 that divides it (1 if
    none), the number of vocab slices the loss streams."""
    if cfg.vocab % 16 == 0:
        return 1
    for c in (8, 5, 4, 10, 7, 3, 2):
        if cfg.vocab % c == 0:
            return c
    return 1


def _moe_layer(cfg, layer: int) -> bool:
    return bool(cfg.n_experts) and layer >= cfg.first_dense_layers


def layer_kinds(cfg) -> list[str]:
    """The kind of each decoder block, in layer order (the reference's
    ``_plan``): ``ssm`` for every layer of the ssm family; for the hybrid
    family ``rglru`` except at every ``attn_period``-th layer, ``attn_mlp``
    (the groups, then the tail by the same rule); ``dec`` for every layer
    of the audio family; else ``attn_moe`` or ``attn_mlp``."""
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "audio":
        return ["dec"] * cfg.n_layers
    if cfg.family == "hybrid":
        period = cfg.attn_period
        return ["rglru" if (i % period + 1) % period else "attn_mlp"
                for i in range(cfg.n_layers)]
    return ["attn_moe" if _moe_layer(cfg, i) else "attn_mlp"
            for i in range(cfg.n_layers)]


def reference_slot(cfg, layer: int) -> tuple[str, Optional[int]]:
    """Where block ``layer``'s parameters sit in the reference's ``init``
    tree: (``lead_{i}``, None) for a leading dense layer, (``layers.b{j}``,
    g) for block j of scanned group g, (``tail_{i}``, None) for a layer
    past the last whole group. (Encoder block g: (``enc_layers``, g).)"""
    n_lead = cfg.first_dense_layers if cfg.family in ("dense", "moe") else 0
    if layer < n_lead:
        return f"lead_{layer}", None
    period = cfg.attn_period if cfg.family == "hybrid" else 1
    n_scan = (cfg.n_layers - n_lead) // period
    g, j = divmod(layer - n_lead, period)
    if g < n_scan:
        return f"layers.b{j}", g
    return f"tail_{layer - n_lead - n_scan * period}", None


#: the stack of the model's cache that each kind of block indexes
_CACHE_OF = {"attn_mlp": "attn", "attn_moe": "attn", "ssm": "ssm",
             "rglru": "lru", "dec": "attn"}


class HybridCache(NamedTuple):
    """A hybrid model's decode cache: its attention layers' ring and its
    recurrent layers' states, each stacked in layer order."""
    attn: attn.KVCache   # [n_attn, B, min(length, window), K, hd]
    lru: LRUCache        # [n_lru, B, W-1, width], [n_lru, B, width]


class EncDecCache(NamedTuple):
    """An encoder-decoder's decode cache: the decoder's self-attention K/V
    and the cross K/V of the encoder's output, each stacked in layer
    order."""
    attn: attn.KVCache   # [L, B, S, K, hd]
    cross: attn.KVCache  # [L, B, enc_len, K, hd]


class Block(torch.nn.Module):
    """Block ``layer`` of the config, by its kind (``layer_kinds``, or
    ``kind`` given: ``enc`` for an encoder block): ``ln1``, ``attn`` (GQA
    or MLA), ``ln2``, then ``moe`` (``attn_moe``) or ``mlp`` (``attn_mlp``
    and ``enc``: of ``dense_d_ff`` in a leading dense layer of an MoE
    config), with ``lnx`` and ``xattn`` (GQA) besides (``dec``); ``ln1``,
    ``ssm`` (``ssm``); or ``ln1``, ``lru``, ``ln2``, ``mlp`` (``rglru``).
    ``slot`` is (the cache stack it reads, its index there)."""

    def __init__(self, cfg, layer: int = 0, device=None,
                 slot: Optional[tuple[str, int]] = ("attn", 0),
                 kind: Optional[str] = None):
        super().__init__()
        self.cfg = cfg
        self.kind = kind or layer_kinds(cfg)[layer]
        self.slot = slot
        self.ln1 = param((cfg.d_model,), device, torch.float32)
        self.attn = self.moe = self.mlp = self.ssm = self.lru = None
        self.ln2 = self.lnx = self.xattn = None
        if self.kind == "ssm":
            self.ssm = Mamba2(cfg, device)
            return
        if self.kind == "rglru":
            self.lru = RGLRU(cfg, device)
        else:
            self.attn = attn.MLAttention(cfg, device) \
                if cfg.attn_kind == "mla" else attn.GQAttention(cfg, device)
        self.ln2 = param((cfg.d_model,), device, torch.float32)
        if self.kind == "dec":
            self.lnx = param((cfg.d_model,), device, torch.float32)
            self.xattn = attn.GQAttention(cfg, device)
        if self.kind == "attn_moe":
            self.moe = MoE(cfg, device)
        else:
            lead = layer < cfg.first_dense_layers
            self.mlp = GatedMLP(cfg.d_model, (cfg.dense_d_ff or cfg.d_ff)
                                if lead else cfg.d_ff, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        rms_norm_init_(self.ln1)
        for sub in (self.attn, self.ssm, self.lru):
            if sub is not None:
                sub.reset_parameters(generator)
        if self.ln2 is not None:
            rms_norm_init_(self.ln2)
            (self.moe or self.mlp).reset_parameters(generator)
        if self.xattn is not None:
            rms_norm_init_(self.lnx)
            self.xattn.reset_parameters(generator)

    def forward(self, x, positions, cache=None, cache_pos=None, *,
                attention=None, routing: Optional[Routing] = None,
                enc_kv: Optional[attn.KVCache] = None):
        """(x, the layer's new cache or None); a MoE layer's balance loss
        is dropped, as serving drops it (the loss's trunk keeps it)."""
        return _block_apply(self, self.cfg, x, positions, cache, cache_pos,
                            attention=attention, routing=routing,
                            enc_kv=enc_kv)[:2]


def _cross_attn(p: attn.GQAttention, cfg, x: torch.Tensor,
                enc_kv: attn.KVCache) -> torch.Tensor:
    """``repro.models.model._cross_attn``: q from x, then ``_sdpa`` without
    a mask over the encoder's K/V (repeated to H heads), then ``wo``."""
    B, S, d = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q = attn._heads(x, p.wq)
    out = attn._sdpa(q, attn._repeat_kv(enc_kv.k, H),
                     attn._repeat_kv(enc_kv.v, H), 1.0 / math.sqrt(hd),
                     causal=False)
    y = out.reshape(B * S, H * hd) @ p.wo.to(x.dtype).reshape(H * hd, d)
    return y.view(B, S, d)


def _enc_kv(p: attn.GQAttention, enc_out: torch.Tensor) -> attn.KVCache:
    """``repro.models.model._enc_kv``: one decoder layer's cross K/V of the
    encoder's output [B, T, d]."""
    return attn.KVCache(attn._heads(enc_out, p.wk), attn._heads(enc_out, p.wv))


def _block_apply(p: Block, cfg, x, positions, cache, cache_pos, *,
                 attention=None, routing: Optional[Routing] = None,
                 enc_kv: Optional[attn.KVCache] = None):
    """``repro.models.model._block_apply``: returns (x, the layer's new
    cache or None, the MoE balance loss: a float32 scalar, None for a block
    without experts, whose aux the reference adds as 0). A ``dec`` block
    cross-attends to ``enc_kv``; an ``enc`` block's attention is
    bidirectional. Neither uses rope (the reference's ``use_rope = not
    cfg.is_encdec``)."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if p.kind == "ssm":
        h, new_cache = p.ssm(h, cache, cache_pos)
        return x + h, new_cache, None
    if p.kind == "rglru":
        h, new_cache = p.lru(h, cache, cache_pos)
        x = x + h
        return x + p.mlp(rms_norm(x, p.ln2, cfg.norm_eps)), new_cache, None
    kw = {}
    if p.kind in ("enc", "dec"):
        kw = dict(causal=p.kind == "dec", use_rope=False)
    h, new_cache = p.attn(h, positions, cache, cache_pos, attention=attention,
                          **kw)
    x = x + h
    if p.kind == "dec":
        x = x + _cross_attn(p.xattn, cfg, rms_norm(x, p.lnx, cfg.norm_eps),
                            enc_kv)
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    aux = None
    if p.moe is not None:
        h, aux = p.moe(h, routing=routing)
    else:
        h = p.mlp(h)
    return x + h, new_cache, aux


def _slots(cfg) -> list[tuple[str, int]]:
    """Each block's (cache stack, index in it), in layer order."""
    seen: dict[str, int] = {}
    out = []
    for kind in layer_kinds(cfg):
        stack = _CACHE_OF[kind]
        out.append((stack, seen.get(stack, 0)))
        seen[stack] = out[-1][1] + 1
    return out


class LM(torch.nn.Module):
    """An LM (dense, vision or MoE with GQA or MLA attention, Mamba-2, the
    RG-LRU hybrid, or an encoder-decoder) with uninitialized bf16 weights on
    ``device`` (default: CUDA); :func:`init` fills them from a
    generator."""

    def __init__(self, cfg, device=None):
        check_ported(cfg, device)
        dev = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        self.embed = param((cfg.vocab, cfg.d_model), dev)
        self.head = None if cfg.tie_embeddings else \
            param((cfg.d_model, cfg.vocab), dev)
        self.final_ln = param((cfg.d_model,), dev, torch.float32)
        self.pos_embed = param((cfg.max_pos, cfg.d_model), dev) \
            if cfg.max_pos else None
        self.layers = torch.nn.ModuleList(
            Block(cfg, i, dev, slot)
            for i, slot in enumerate(_slots(cfg)))
        self.enc_layers = self.enc_ln = None
        if cfg.is_encdec:
            self.enc_layers = torch.nn.ModuleList(
                Block(cfg, g, dev, None, kind="enc")
                for g in range(cfg.enc_layers))
            self.enc_ln = param((cfg.d_model,), dev, torch.float32)

    def reset_parameters(self, generator: torch.Generator) -> None:
        embedding_init_(self.embed, generator)
        if self.head is not None:
            dense_init_(self.head, generator)
        rms_norm_init_(self.final_ln)
        if self.pos_embed is not None:  # 0.02 x a standard normal
            normal_init_(self.pos_embed, generator, 0.02)
        for block in self.layers:
            block.reset_parameters(generator)
        if self.enc_layers is not None:
            for block in self.enc_layers:
                block.reset_parameters(generator)
            rms_norm_init_(self.enc_ln)


def init(cfg, generator: torch.Generator, device=None) -> LM:
    """``repro.models.model.init``: every weight drawn from ``generator``
    straight into bf16 on ``device``, one tensor at a time (no float32
    master copies). The draws are not JAX's; the tests load the reference's
    weights with ``convert.lm_params_from_numpy``."""
    model = LM(cfg, device)
    model.reset_parameters(generator)
    return model


Cache = attn.KVCache | attn.MLACache | SSMCache | HybridCache | EncDecCache


def _stacks(cfg, cache: Cache) -> dict:
    """The cache's stacks by the name blocks index them with (and
    ``cross``, which ``dec`` blocks read)."""
    if isinstance(cache, (HybridCache, EncDecCache)):
        return cache._asdict()
    return {"ssm" if cfg.family == "ssm" else "attn": cache}


def _from_stacks(stacks: dict) -> Cache:
    if "cross" in stacks:
        return EncDecCache(**stacks)
    return HybridCache(**stacks) if len(stacks) > 1 \
        else next(iter(stacks.values()))


def _sinusoid(n: int, d: int, device=None) -> torch.Tensor:
    """``repro.models.model._sinusoid``: [n, d] float32, ``[sin | cos]`` of
    position / 10000^(2·i/d) for i < d/2."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device),
                          2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _embed_inputs(model: LM, tokens: torch.Tensor,
                  positions: Optional[torch.Tensor],
                  images: Optional[torch.Tensor]) -> torch.Tensor:
    """``repro.models.model._embed_inputs``: the token embeddings in bf16,
    plus the learned positions at ``positions`` (None: arange(S)) with
    ``max_pos``; with ``images`` [B, >= P, d], the first P = min(n_patches,
    S) slots are the patch embeddings cast to bf16."""
    cfg = model.cfg
    x = embed(model.embed, tokens, torch.bfloat16)
    if cfg.max_pos:
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = x + model.pos_embed.to(x.dtype)[positions]
    if images is not None:
        P = min(cfg.n_patches, x.shape[1])
        x = torch.cat([images[:, :P].to(x.dtype), x[:, P:]], dim=1)
    return x


def _encode(model: LM, frames: torch.Tensor, attention=None) -> torch.Tensor:
    """``repro.models.model._encode``: the encoder over the frame embeddings
    [B, T, d]: bf16 frames plus the sinusoid in bf16, the ``enc`` blocks
    (bidirectional, no rope: K5 with ``causal=False`` on CUDA), ``enc_ln``."""
    cfg = model.cfg
    x = frames.to(torch.bfloat16) + _sinusoid(
        frames.shape[1], cfg.d_model, frames.device).to(torch.bfloat16)[None]
    for block in model.enc_layers:
        x, _ = block(x, None, attention=attention)
    return rms_norm(x, model.enc_ln, cfg.norm_eps)


#: the model's ``routing=`` hook: (layer, probs, k) -> expert indices
LayerRouting = Callable[[int, torch.Tensor, int], torch.Tensor]


def _layer_routing(routing: Optional[LayerRouting],
                   layer: int) -> Optional[Routing]:
    """Block ``layer``'s ``moe_apply`` hook: ``routing`` bound to the
    layer."""
    return None if routing is None else functools.partial(routing, layer)


def _block_hidden(block: Block, x: torch.Tensor, attention,
                  routing: Optional[Routing],
                  enc_kv: Optional[attn.KVCache] = None):
    """One block of the loss's trunk (positions arange(S), no cache; a
    ``dec`` block cross-attends to ``enc_kv``) -> (x, its MoE balance loss
    or None)."""
    x, _, aux = _block_apply(block, block.cfg, x, None, None, None,
                             attention=attention, routing=routing,
                             enc_kv=enc_kv)
    return x, aux


def _loss_trunk(model: LM, tokens: torch.Tensor,
                images: Optional[torch.Tensor], attention,
                routing: Optional[LayerRouting], remat: bool,
                frames: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The loss's trunk (the reference's ``_forward`` with
    ``want_cache=False``) -> (hidden [B, S, d], aux): positions arange(S),
    no layer builds a cache; ``remat`` recomputes each decoder block in the
    backward (``torch.utils.checkpoint``, non-reentrant) in place of
    keeping its activations. An encoder-decoder first encodes ``frames``
    (its encoder blocks outside remat, as the reference's ``_encode`` runs
    outside its checkpointed scan) and takes each decoder layer's cross K/V
    of the encoding outside its block, as the reference's ``vmap`` of
    ``_enc_kv`` does. ``aux`` is the MoE layers' balance losses summed in
    layer order from a float32 0 (the reference's ``aux_total``: its lead,
    scanned and tail blocks in that order)."""
    cfg = model.cfg
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x = _embed_inputs(model, tokens, None, images)
    enc_kv = [None] * len(model.layers)
    if cfg.is_encdec:
        enc_out = _encode(model, frames, attention)
        enc_kv = [_enc_kv(block.xattn, enc_out) for block in model.layers]
        del enc_out
    for i, block in enumerate(model.layers):
        args = (block, x, attention, _layer_routing(routing, i), enc_kv[i])
        x, a = checkpoint(_block_hidden, *args, use_reentrant=False) \
            if remat else _block_hidden(*args)
        if a is not None:
            aux = aux + a
    return rms_norm(x, model.final_ln, cfg.norm_eps), aux


def _forward(model: LM, tokens: torch.Tensor,
             positions: Optional[torch.Tensor],
             cache_pos: int, cache: Optional[Cache] = None,
             attention=None, routing: Optional[LayerRouting] = None,
             frames: Optional[torch.Tensor] = None,
             images: Optional[torch.Tensor] = None
             ) -> tuple[torch.Tensor, Cache]:
    """The prefill/decode trunk -> (hidden [B, S, d], cache): a prefill
    (``cache`` and ``positions`` None: positions arange(S)) returns the
    layers' new caches stacked by kind, field by field (and, for an
    encoder-decoder, the cross K/V of ``frames``' encoding), a decode step
    the ``cache`` it wrote into. The MoE layers' balance losses are
    dropped, as the reference's serving drops them."""
    cfg = model.cfg
    x = _embed_inputs(model, tokens, positions, images)
    stacks = None if cache is None else _stacks(cfg, cache)
    enc_kv = None
    if cfg.is_encdec and cache is None:
        enc_out = _encode(model, frames, attention)
        enc_kv = [_enc_kv(block.xattn, enc_out) for block in model.layers]
        del enc_out
    new: dict[str, list] = {}
    for i, block in enumerate(model.layers):
        name, j = block.slot
        c = None if stacks is None else \
            type(stacks[name])(*(f[j] for f in stacks[name]))
        kv = None
        if block.kind == "dec":
            kv = enc_kv[j] if stacks is None else \
                attn.KVCache(*(f[j] for f in stacks["cross"]))
            if stacks is None:
                new.setdefault("cross", []).append(kv)
        x, nc = block(x, positions, c, cache_pos, attention=attention,
                      routing=_layer_routing(routing, i), enc_kv=kv)
        new.setdefault(name, []).append(nc)
    x = rms_norm(x, model.final_ln, cfg.norm_eps)
    if cache is None:
        cache = _from_stacks({
            name: type(cs[0])(*(torch.stack(f) for f in zip(*cs)))
            for name, cs in new.items()})
    return x, cache


def _head(model: LM) -> torch.Tensor:
    return model.embed if model.cfg.tie_embeddings else model.head


def _check_inputs(cfg, tokens: torch.Tensor, frames, images,
                  what: str = "prefill") -> None:
    B, S = tokens.shape
    if cfg.is_encdec:
        if frames is None:
            raise ValueError(f"{what}: {cfg.arch_id} needs frames [B, "
                             f"{cfg.enc_len}, {cfg.d_model}]")
        if tuple(frames.shape) != (B, cfg.enc_len, cfg.d_model):
            raise ValueError(f"{what}: frames must be [{B}, {cfg.enc_len}, "
                             f"{cfg.d_model}] (the decode cache holds "
                             f"enc_len cross positions), got "
                             f"{tuple(frames.shape)}")
    elif frames is not None:
        raise ValueError(f"{what}: {cfg.arch_id} has no encoder for frames")
    if images is not None:
        if cfg.frontend != "vision":
            raise ValueError(f"{what}: {cfg.arch_id} has no vision "
                             "frontend for images")
        P = min(cfg.n_patches, S)
        if images.dim() != 3 or images.shape[0] != B or \
                images.shape[1] < P or images.shape[2] != cfg.d_model:
            raise ValueError(f"{what}: images must be [{B}, >= {P}, "
                             f"{cfg.d_model}], got {tuple(images.shape)}")


def loss_fn(model: LM, batch: dict, remat: Optional[bool] = None,
            attention=None, routing: Optional[LayerRouting] = None
            ) -> tuple[torch.Tensor, dict]:
    """``repro.models.model.loss_fn``: ``batch["tokens"]`` [B, S+1]
    (inputs ``[:, :-1]``, labels ``[:, 1:]``, positions arange(S)); for an
    encoder-decoder ``batch["frames"]`` [B, enc_len, d], the frame
    embeddings its encoder reads; for a vision config, optionally
    ``batch["images"]`` [B, >= min(n_patches, S), d], the patch embeddings
    of the first slots ->
    (loss, {"ce", "aux"}), loss = ce + 0.01·aux: aux the MoE layers'
    balance losses summed in layer order (0 without experts), ce over the
    positions at and past ``n_patches`` for a vision config (with or
    without images, as the reference masks them), over all else.
    ``frames`` or ``images`` a config cannot take are refused. ``remat``
    (default ``cfg.remat``) recomputes each block in the backward;
    ``attention`` replaces the attention as in :func:`prefill`;
    ``routing`` as in :func:`prefill` (see the module docstring: under
    remat a layer's hook runs again in the backward). Every family of the
    registry."""
    cfg = model.cfg
    check_ported(cfg)
    remat = cfg.remat if remat is None else remat
    tokens_full = batch["tokens"].to(torch.int64)
    tokens, labels = tokens_full[:, :-1], tokens_full[:, 1:]
    B, S = tokens.shape
    images, frames = batch.get("images"), batch.get("frames")
    _check_inputs(cfg, tokens, frames, images, "loss_fn")
    x, aux = _loss_trunk(model, tokens, images, attention, routing, remat,
                         frames)
    mask = torch.ones((B, S), dtype=torch.bool, device=x.device)
    if cfg.frontend == "vision":
        mask &= (torch.arange(S, device=x.device) >= cfg.n_patches)[None, :]
    ce = cross_entropy(_head(model), x, labels, mask, cfg.tie_embeddings,
                       n_chunks=xent_chunks(cfg))
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor, *,
            frames: Optional[torch.Tensor] = None,
            images: Optional[torch.Tensor] = None, attention=None,
            routing: Optional[LayerRouting] = None
            ) -> tuple[Cache, torch.Tensor]:
    """Process the prompt ``tokens`` [B, S]; returns (the cache, its layers
    stacked by kind: [L, B, S, K, hd] K/V, the MLA latent and rope key, the
    SSM states, a ``HybridCache`` of the attention layers' K/V and the
    recurrent states, or an ``EncDecCache``; last-position logits [B, V]).
    An encoder-decoder needs ``frames`` [B, enc_len, d], the precomputed
    frame embeddings its encoder reads (another length is refused: the
    decode cache holds ``enc_len`` cross positions); a vision config takes
    ``images`` [B, >= min(n_patches, S), d], the patch embeddings of its
    prompt's first slots. ``attention`` replaces the prefill attention, the
    encoder's included (see :mod:`repro_torch.models.attention`);
    ``routing(layer, probs, k)`` makes each MoE layer's expert choice
    (see the module docstring and :mod:`repro_torch.models.moe`)."""
    _check_inputs(model.cfg, tokens, frames, images)
    x, cache = _forward(model, tokens, None, tokens.shape[1],
                        attention=attention, routing=routing, frames=frames,
                        images=images)
    logits = lm_head(_head(model), x[:, -1:], model.cfg.tie_embeddings)[:, 0]
    return cache, logits


@torch.no_grad()
def decode_step(model: LM, cache: Cache, token: torch.Tensor, pos: int, *,
                routing: Optional[LayerRouting] = None
                ) -> tuple[Cache, torch.Tensor]:
    """One decode step. ``token`` [B], ``pos`` the write position (the
    number of tokens already in the cache). The cache is updated in place
    (an encoder-decoder's cross K/V only read) and returned with the logits
    [B, V]. ``routing`` as for :func:`prefill`."""
    B = token.shape[0]
    positions = torch.full((B, 1), int(pos), dtype=torch.int32,
                           device=token.device)
    x, cache = _forward(model, token[:, None], positions, int(pos), cache,
                        routing=routing)
    logits = lm_head(_head(model), x, model.cfg.tie_embeddings)[:, 0]
    return cache, logits


def init_cache(cfg, batch: int, length: int, dtype=torch.bfloat16,
               device=None) -> Cache:
    """Zeroed decode caches for ``batch`` sequences of at most ``length``
    tokens, each kind's layers stacked: [L, B, length, K, hd] K/V for GQA
    (a ring of min(length, window) slots with a window), [L, B, length,
    kv_lora] and [L, B, length, rope] for MLA, an ``SSMCache`` for SSM, a
    ``HybridCache`` for the hybrid, an ``EncDecCache`` (its cross K/V
    zeroed at ``enc_len`` positions, as the reference's) for an
    encoder-decoder."""
    check_ported(cfg, device)
    dev = resolve_device(device)
    counts: dict[str, int] = {}
    for name, _ in _slots(cfg):
        counts[name] = counts.get(name, 0) + 1
    stacks = {}
    for name, n in counts.items():
        if name == "ssm":
            stacks[name] = init_ssm_cache(cfg, batch, dtype, dev, n_layers=n)
        elif name == "lru":
            stacks[name] = init_lru_cache(cfg, batch, dtype, dev, n_layers=n)
        else:
            init = attn.init_mla_cache if cfg.attn_kind == "mla" \
                else attn.init_kv_cache
            stacks[name] = init(cfg, batch, length, dtype, dev, n_layers=n)
    if cfg.is_encdec:
        shape = (cfg.n_layers, batch, cfg.enc_len, cfg.n_kv_heads,
                 cfg.head_dim)
        stacks["cross"] = attn.KVCache(
            torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))
    return _from_stacks(stacks)
