"""Carry state across from the JAX package as numpy arrays.

A JAX ``GPParams`` / ``GPState`` is a NamedTuple of arrays; ``np.asarray``
of each field gives what these functions take. Candidate pools and the
importance vector ``v`` already pass as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gp import GPParams, GPState
from repro_torch.device import resolve_device

__all__ = ["gp_params_from_numpy", "gp_state_from_numpy"]


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
