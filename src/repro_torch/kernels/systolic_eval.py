"""``systolic_eval``: the batched SoC cost model (kernel K1).

:func:`soc_metrics` evaluates ``vals`` [N, 26] against ``layers`` [L, 5] and
returns [N, 3] (latency ms, power mW, area mm²). On a CPU tensor it runs the
plain version (:func:`soc_metrics_plain`, the [N, L]-broadcast PyTorch
model); on a CUDA tensor it launches ``csrc/systolic_eval.cu`` or raises.
"""
from __future__ import annotations

import torch

from repro_torch.soc.model import metrics_tile as soc_metrics_plain

from . import build
from ._common import check_tensor, on_cpu

__all__ = ["soc_metrics", "soc_metrics_plain", "launches"]

#: kernel launches since the count was last set to 0
launches = 0

#: the layer table is staged in 48 KB of static-limit shared memory
MAX_LAYERS = (48 * 1024) // (5 * 4)
N_FEATURES = 26


def soc_metrics(vals: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
    global launches
    check_tensor("vals", vals, 2)
    check_tensor("layers", layers, 2)
    if vals.shape[1] != N_FEATURES or layers.shape[1] != 5:
        raise ValueError(f"systolic_eval: expected vals [N, {N_FEATURES}] and "
                         f"layers [L, 5], got {tuple(vals.shape)} and "
                         f"{tuple(layers.shape)}")
    if on_cpu(vals, layers):
        return soc_metrics_plain(vals, layers)
    n, n_layers = vals.shape[0], layers.shape[0]
    if not 0 < n_layers <= MAX_LAYERS:
        raise ValueError(f"systolic_eval: 1..{MAX_LAYERS} layers supported, "
                         f"got {n_layers}")
    out = torch.empty((n, 3), dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    err = build.library().systolic_eval_launch(
        vals.data_ptr(), layers.data_ptr(), out.data_ptr(), n, n_layers,
        build.stream_ptr(vals))
    build.check(err, "systolic_eval")
    launches += 1
    return out
