"""The system under test: the ``repro_torch`` model a configuration names,
built at the configuration's sizes with the harness's weights. This and
the drivers are the only modules of the benchmark that import the program;
the reference imports none of it."""
from __future__ import annotations

import dataclasses

import torch

from . import weights
from .sizes import Sizes

#: the program's config field for each size of the configuration's file
_FIELDS = {"n_layers": "n_layers", "d": "d_model", "heads": "n_heads",
           "kv_heads": "n_kv_heads", "vocab": "vocab", "rope_theta": "rope_theta",
           "eps": "norm_eps", "kv_lora": "kv_lora", "q_lora": "q_lora",
           "nope": "qk_nope_dim", "rope_dim": "qk_rope_dim", "v_dim": "v_head_dim",
           "experts": "n_experts", "top_k": "top_k", "shared": "n_shared",
           "moe_ff": "moe_d_ff", "first_dense": "first_dense_layers",
           "capacity_factor": "capacity_factor"}


def arch(config: dict, sizes: Sizes):
    """The program's ``ArchConfig`` of the registry entry the configuration
    names, with its ``port_overrides`` (a cut in depth, or a published
    setting the registry entry does not hold), checked to agree
    with every size of the configuration's file."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(config["registry"]),
                              **config.get("port_overrides", {}))
    want = {f: getattr(sizes, k) for k, f in _FIELDS.items()
            if sizes.attn == "mla" or k not in ("kv_lora", "q_lora", "nope",
                                                "rope_dim", "v_dim")}
    if sizes.attn == "gqa":
        want["head_dim"] = sizes.head_dim
    if sizes.experts:
        want["dense_d_ff"] = sizes.ff
    else:
        want["d_ff"] = sizes.ff
        for f in ("n_experts", "top_k", "n_shared", "moe_d_ff",
                  "first_dense_layers", "capacity_factor"):
            want.pop(f)
    want["attn_kind"] = sizes.attn
    diff = {f: (getattr(cfg, f), v) for f, v in want.items() if getattr(cfg, f) != v}
    if diff or cfg.tie_embeddings or cfg.qk_norm or cfg.window:
        raise ValueError(f"the program's {cfg.arch_id} is not the configuration "
                         f"{sizes.name}: (program, file) {diff}")
    return cfg


def serving_model(cfg, sizes: Sizes, seed: int, device):
    """An ``LM`` with the seed's weights drawn into its parameters."""
    from repro_torch.models import LM

    model = LM(cfg, device)
    weights.fill_named_(dict(model.named_parameters()), sizes, seed)
    return model


def masters(cfg, sizes: Sizes, seed: int, device) -> dict:
    """float32 master weights keyed by the program's parameter names."""
    from repro_torch.models import LM

    model = LM(cfg, "meta")
    named = {n: torch.empty(p.shape, dtype=torch.float32, device=device)
             for n, p in model.named_parameters()}
    weights.fill_named_(named, sizes, seed)
    return named
