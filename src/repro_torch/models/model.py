"""Model assembly for the dense and MoE plans: ``ArchConfig`` -> an ``LM``
module and its ``prefill`` / ``decode_step`` / ``init_cache``.

A port of ``repro.models.model`` for the dense and ``moe`` families: pre-norm
GQA or MLA attention, then a gated MLP (``attn_mlp``) or a Mixture-of-Experts
(``attn_moe``, :mod:`.moe`) per block. A block is ``attn_moe`` when the
config has experts and its layer is at or past ``first_dense_layers``; the
leading dense layers (deepseek's layer 0) are ``attn_mlp`` with an MLP of
``dense_d_ff`` (``d_ff`` when 0). The reference keeps those lead layers
outside its scan (``lead_{i}``) and scans the rest; here ``_forward`` loops
over one ``nn.ModuleList`` of all blocks in layer order. The parameter
layout is the reference's ``init`` tree with the stacked ``layers.b0``
split into one block per layer: ``embed`` [V, d], ``head`` [d, V] (untied),
``final_ln`` [d] and, per block, ``ln1``, ``attn.{wq,wk,wv,wo,q_norm,
k_norm}`` (GQA) or ``attn.{wq_a,wq_b,wq,wkv_a,wkv_b,wo,kv_norm}`` (MLA),
``ln2``, and ``mlp.{wg,wu,wd}`` or ``moe.{router,wg,wu,wd,shared}``.

The compute dtype is bf16, as in the reference's ``_forward``. The decode
cache is the caches of all layers stacked (the reference's ``lead_{i}``
caches, then its ``caches["layers"]["b0"]["attn"]``): a
:class:`~repro_torch.models.attention.KVCache` [L, B, S, K, hd] for GQA, an
:class:`~repro_torch.models.attention.MLACache` ([L, B, S, kv_lora],
[L, B, S, rope]) for MLA; ``decode_step`` writes it in place. The MoE
layers' load-balancing loss is computed and dropped, as the reference's
serving drops it. SSM, hybrid, audio and vision configs raise
``NotImplementedError`` when built, on any device; a sliding window raises
when built for CUDA.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.device import resolve_device
from . import attention as attn
from .moe import MoE, Routing
from .layers import (GatedMLP, embed, embedding_init_, dense_init_, lm_head,
                     param, rms_norm, rms_norm_init_)

__all__ = ["LM", "Block", "init", "prefill", "decode_step", "init_cache",
           "check_ported"]


def check_ported(cfg, device: torch.device | str | None = None) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run (on
    ``device``; None means CUDA, the default)."""
    why = None
    if cfg.family not in ("dense", "moe"):
        why = f"the {cfg.family} family"
    elif cfg.attn_kind not in ("gqa", "mla"):
        why = f"{cfg.attn_kind} attention"
    elif cfg.frontend or cfg.is_encdec or cfg.max_pos:
        why = "frontends and encoder-decoders"
    elif cfg.window and torch.device(device or "cuda").type == "cuda":
        why = "sliding-window attention on CUDA"
    if why is not None:
        raise NotImplementedError(
            f"repro_torch: {why} ({cfg.arch_id}) is not yet ported "
            "(ROADMAP queue 1)")


def _moe_layer(cfg, layer: int) -> bool:
    return bool(cfg.n_experts) and layer >= cfg.first_dense_layers


class Block(torch.nn.Module):
    """Block ``layer`` of the config: ``ln1``, ``attn`` (GQA or MLA),
    ``ln2``, then ``moe`` (an ``attn_moe`` block) or ``mlp`` (``attn_mlp``:
    of ``dense_d_ff`` in a leading dense layer of an MoE config)."""

    def __init__(self, cfg, layer: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.ln1 = param((cfg.d_model,), device, torch.float32)
        self.attn = attn.MLAttention(cfg, device) if cfg.attn_kind == "mla" \
            else attn.GQAttention(cfg, device)
        self.ln2 = param((cfg.d_model,), device, torch.float32)
        self.moe = self.mlp = None
        if _moe_layer(cfg, layer):
            self.moe = MoE(cfg, device)
        else:
            lead = layer < cfg.first_dense_layers
            self.mlp = GatedMLP(cfg.d_model, (cfg.dense_d_ff or cfg.d_ff)
                                if lead else cfg.d_ff, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        rms_norm_init_(self.ln1)
        self.attn.reset_parameters(generator)
        rms_norm_init_(self.ln2)
        (self.moe or self.mlp).reset_parameters(generator)

    def forward(self, x, positions, cache=None, cache_pos=None, *,
                attention=None, routing: Optional[Routing] = None):
        return _block_apply(self, self.cfg, x, positions, cache, cache_pos,
                            attention=attention, routing=routing)


def _block_apply(p: Block, cfg, x, positions, cache, cache_pos, *,
                 attention=None, routing: Optional[Routing] = None):
    """``repro.models.model._block_apply`` for ``attn_mlp`` and
    ``attn_moe``: returns (x, the layer's new cache or None)."""
    h, new_cache = p.attn(rms_norm(x, p.ln1, cfg.norm_eps), positions,
                          cache, cache_pos, attention=attention)
    x = x + h
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if p.moe is not None:
        h, _ = p.moe(h, routing=routing)
    else:
        h = p.mlp(h)
    return x + h, new_cache


class LM(torch.nn.Module):
    """A decoder LM (GQA or MLA attention; MLP or MoE blocks) with
    uninitialized bf16 weights on ``device`` (default: CUDA); :func:`init`
    fills them from a generator."""

    def __init__(self, cfg, device=None):
        check_ported(cfg, device)
        dev = resolve_device(device)
        super().__init__()
        self.cfg = cfg
        self.embed = param((cfg.vocab, cfg.d_model), dev)
        self.head = None if cfg.tie_embeddings else \
            param((cfg.d_model, cfg.vocab), dev)
        self.final_ln = param((cfg.d_model,), dev, torch.float32)
        self.layers = torch.nn.ModuleList(
            Block(cfg, i, dev) for i in range(cfg.n_layers))

    def reset_parameters(self, generator: torch.Generator) -> None:
        embedding_init_(self.embed, generator)
        if self.head is not None:
            dense_init_(self.head, generator)
        rms_norm_init_(self.final_ln)
        for block in self.layers:
            block.reset_parameters(generator)


def init(cfg, generator: torch.Generator, device=None) -> LM:
    """``repro.models.model.init`` for the dense and MoE plans: every weight
    drawn from ``generator`` straight into bf16 on ``device``, one tensor at
    a time (no float32 master copies). The draws are not JAX's; the tests
    load the reference's weights with ``convert.lm_params_from_numpy``."""
    model = LM(cfg, device)
    model.reset_parameters(generator)
    return model


Cache = attn.KVCache | attn.MLACache


def _forward(model: LM, tokens: torch.Tensor,
             positions: Optional[torch.Tensor],
             cache_pos: int, cache: Optional[Cache] = None,
             attention=None, routing: Optional[Routing] = None
             ) -> tuple[torch.Tensor, Cache]:
    """The prefill/decode trunk -> (hidden [B, S, d], cache): a prefill
    (``cache`` and ``positions`` None: positions arange(S)) returns the
    layers' new caches stacked field by field (K/V, or latent/k_rope), a
    decode step the ``cache`` it wrote into."""
    cfg = model.cfg
    kind = attn.MLACache if cfg.attn_kind == "mla" else attn.KVCache
    x = embed(model.embed, tokens, torch.bfloat16)
    layer_caches = []
    for i, block in enumerate(model.layers):
        c = None if cache is None else kind(*(f[i] for f in cache))
        x, nc = block(x, positions, c, cache_pos, attention=attention,
                      routing=routing)
        layer_caches.append(nc)
    x = rms_norm(x, model.final_ln, cfg.norm_eps)
    if cache is None:
        cache = kind(*(torch.stack(f) for f in zip(*layer_caches)))
    return x, cache


def _head(model: LM) -> torch.Tensor:
    return model.embed if model.cfg.tie_embeddings else model.head


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor, *, attention=None,
            routing: Optional[Routing] = None) -> tuple[Cache, torch.Tensor]:
    """Process the prompt ``tokens`` [B, S]; returns (cache, the layers
    stacked: [L, B, S, K, hd] K/V, or the MLA latent and rope key;
    last-position logits [B, V]). ``attention`` replaces the causal prefill
    attention (see :mod:`repro_torch.models.attention`); ``routing`` is
    called for the expert choice of each MoE layer in turn (see
    :mod:`repro_torch.models.moe`)."""
    x, cache = _forward(model, tokens, None, tokens.shape[1],
                        attention=attention, routing=routing)
    logits = lm_head(_head(model), x[:, -1:], model.cfg.tie_embeddings)[:, 0]
    return cache, logits


@torch.no_grad()
def decode_step(model: LM, cache: Cache, token: torch.Tensor, pos: int, *,
                routing: Optional[Routing] = None
                ) -> tuple[Cache, torch.Tensor]:
    """One decode step. ``token`` [B], ``pos`` the write position (the
    number of tokens already in the cache). The cache is updated in place
    and returned with the logits [B, V]. ``routing`` as for
    :func:`prefill`."""
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
    tokens, the layers stacked: [L, B, length, K, hd] K/V for GQA, or
    [L, B, length, kv_lora] and [L, B, length, rope] for MLA."""
    check_ported(cfg, device)
    init = attn.init_mla_cache if cfg.attn_kind == "mla" \
        else attn.init_kv_cache
    return init(cfg, batch, length, dtype, resolve_device(device),
                n_layers=cfg.n_layers)
