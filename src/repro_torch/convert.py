"""Carry state across from the JAX package as numpy arrays.

A JAX ``GPParams`` / ``GPState`` is a NamedTuple of arrays; ``np.asarray``
of each field gives what these functions take. Candidate pools and the
importance vector ``v`` already pass as numpy arrays; an LM's parameter tree
passes as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import ENGINE_STATE_FORMAT
from repro_torch.core.gp import GPParams, GPState
from repro_torch.device import resolve_device

__all__ = ["gp_params_from_numpy", "gp_state_from_numpy",
           "engine_state_from_numpy", "lm_params_from_numpy"]


def _t(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)


def gp_params_from_numpy(d: dict, device=None) -> GPParams:
    """``{log_ls [m,d], log_var [m], log_noise [m]}`` -> :class:`GPParams`."""
    dev = resolve_device(device)
    return GPParams(_t(d["log_ls"], dev), _t(d["log_var"], dev),
                    _t(d["log_noise"], dev))


def gp_state_from_numpy(params: dict, x, y, y_mean, y_std, chol, alpha,
                        device=None) -> GPState:
    """A whole posterior state: ``params`` as for :func:`gp_params_from_numpy`;
    ``x`` [n,d], ``y`` [n,m], ``y_mean``/``y_std`` [m], ``chol`` [m,n,n],
    ``alpha`` [m,n]."""
    dev = resolve_device(device)
    return GPState(gp_params_from_numpy(params, dev), _t(x, dev), _t(y, dev),
                   _t(y_mean, dev), _t(y_std, dev), _t(chol, dev),
                   _t(alpha, dev))


def engine_state_from_numpy(d: dict) -> dict:
    """A JAX ``BOEngine.state_dict()`` (or ``BatchedBOEngine``'s) as a
    snapshot for the port's ``load_state_dict``. The key layout is the same;
    every array is copied into an owned numpy array of the port's dtype (JAX
    hands out read-only views of its buffers)."""
    if d.get("format") != ENGINE_STATE_FORMAT or \
            d.get("kind") not in ("BOEngine", "BatchedBOEngine"):
        raise ValueError(f"not an engine snapshot of format "
                         f"{ENGINE_STATE_FORMAT}: format={d.get('format')!r}, "
                         f"kind={d.get('kind')!r}")
    dtypes = {"rows": np.int64, "rows_pad": np.int32, "ids": np.int64}

    def copy(key, v):
        if isinstance(v, dict):  # the batched engine's per-scenario rows/ys
            return {k: copy(key if key in ("rows", "ys") else k, x)
                    for k, x in v.items()}
        if v is None or isinstance(v, (bool, int, float, str, list)):
            return v
        return np.array(v, dtypes.get(key, np.float32))

    return {k: copy(k, v) for k, v in d.items()}


def lm_params_from_numpy(cfg, tree: dict, device=None):
    """The reference's ``repro.models.init`` tree (numpy) as the port's
    :class:`~repro_torch.models.LM` on ``device``: the scanned blocks
    stacked ``[n, ...]`` under ``layers.b{j}`` (block j of group g is layer
    ``g * period + j``, after the leading dense layers ``lead_{i}``), the
    hybrid's remainder under ``tail_{i}``, the ``attn``/``mlp``/``moe``/
    ``ssm``/``lru`` leaves of each block and a ``dec`` block's ``lnx`` and
    ``xattn``; ``pos_embed``; an encoder's blocks stacked ``[enc_layers,
    ...]`` under ``enc_layers`` (not under ``b{j}``) and ``enc_ln``;
    matrices rounded to bf16 (as the reference's launcher casts every
    parameter of more than one dim), the rest kept in float32."""
    from repro_torch.models import LM
    from repro_torch.models.model import reference_slot

    model = LM(cfg, device)

    def load(dst: torch.Tensor, src) -> None:
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"shape {src.shape} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))

    def leaf(sub: dict, dotted: str, i):
        for key in dotted.split("."):
            sub = sub[key]
        return sub if i is None else sub[i]

    with torch.no_grad():
        load(model.embed, tree["embed"])
        if model.head is not None:
            load(model.head, tree["head"])
        load(model.final_ln, tree["final_ln"])
        if model.pos_embed is not None:
            load(model.pos_embed, tree["pos_embed"])
        blocks = [(b, *reference_slot(cfg, i))
                  for i, b in enumerate(model.layers)]
        if model.enc_layers is not None:
            load(model.enc_ln, tree["enc_ln"])
            blocks += [(b, "enc_layers", g)
                       for g, b in enumerate(model.enc_layers)]
        for block, path, j in blocks:
            sub = leaf(tree, path, None)
            for name, w in block.named_parameters():
                load(w, leaf(sub, name, j))
    return model
