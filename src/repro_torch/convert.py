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
           "engine_state_from_numpy", "lm_params_from_numpy",
           "train_state_from_numpy", "reference_checkpoint_tree"]


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


def _reference_leaves(cfg, model) -> list[tuple[str, torch.Tensor, str,
                                               "int | None"]]:
    """(the port's parameter name, the tensor, its path in the reference's
    ``init`` tree (dotted), the index into a stacked leaf or None), for
    every parameter of ``model``."""
    from repro_torch.models.model import reference_slot

    out = [(name, getattr(model, name), name, None)
           for name in ("embed", "head", "final_ln", "pos_embed", "enc_ln")
           if getattr(model, name) is not None]
    blocks = [(f"layers.{i}", b, *reference_slot(cfg, i))
              for i, b in enumerate(model.layers)]
    if model.enc_layers is not None:
        blocks += [(f"enc_layers.{g}", b, "enc_layers", g)
                   for g, b in enumerate(model.enc_layers)]
    for prefix, block, path, j in blocks:
        for name, w in block.named_parameters():
            out.append((f"{prefix}.{name}", w, f"{path}.{name}", j))
    return out


def _leaf(tree: dict, dotted: str, i):
    for key in dotted.split("."):
        tree = tree[key]
    return tree if i is None else tree[i]


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

    model = LM(cfg, device)
    with torch.no_grad():
        for _, dst, path, j in _reference_leaves(cfg, model):
            src = np.asarray(_leaf(tree, path, j))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{path}: shape {src.shape} does not fit "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, np.float32)))
    return model


def reference_checkpoint_tree(arrays) -> dict:
    """A reference checkpoint's ``arrays.npz`` (or any mapping of its flat
    names, ``.step``, ``.params/layers/b0/attn/wq``, ...) as the nested
    tree :func:`train_state_from_numpy` takes."""
    tree: dict = {}
    for name in arrays:
        keys = name.lstrip(".").split("/")
        sub = tree
        for key in keys[:-1]:
            sub = sub.setdefault(key, {})
        sub[keys[-1]] = np.asarray(arrays[name])
    return tree


def train_state_from_numpy(cfg, tree: dict, device=None):
    """A reference ``TrainState`` (numpy: ``{"step", "params", "m", "v"}``,
    each of the last three a tree of the reference's ``init``; e.g.
    ``jax.tree.map(np.asarray, state)._asdict()``, or
    :func:`reference_checkpoint_tree` of a checkpoint's arrays) as the
    port's :class:`~repro_torch.train.TrainState` on ``device``: float32
    masters and moments keyed by the ``LM``'s parameter names (the stacked
    leaves split as :func:`lm_params_from_numpy` splits them), the step an
    int32 scalar."""
    from repro_torch.models import LM
    from repro_torch.train.optimizer import TrainState

    dev = resolve_device(device)
    # the names and shapes only: empty CPU tensors, never filled
    leaves = _reference_leaves(cfg, LM(cfg, "cpu"))

    def part(sub: dict) -> dict:
        out = {}
        for name, like, path, j in leaves:
            src = np.asarray(_leaf(sub, path, j))
            if tuple(src.shape) != tuple(like.shape):
                raise ValueError(f"{path}: shape {src.shape} does not fit "
                                 f"{tuple(like.shape)}")
            out[name] = torch.tensor(np.array(src, np.float32), device=dev)
        return out

    return TrainState(
        torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                     device=dev),
        part(tree["params"]), part(tree["m"]), part(tree["v"]))
