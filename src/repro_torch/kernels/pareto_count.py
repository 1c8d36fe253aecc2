"""``pareto_count``: strict-dominance counts for minimization (kernel K3).

:func:`dominance_counts` returns, for each row of ``y`` [N, m] (float32),
the number of rows q with all(q <= p) and any(q < p), as int32 [N]. On a
CPU tensor it runs :func:`dominance_counts_plain`; on a CUDA tensor it
launches ``csrc/pareto_count.cu`` or raises.
"""
from __future__ import annotations

import torch

from . import build
from ._common import check_tensor, on_cpu

__all__ = ["dominance_counts", "dominance_counts_plain", "launches"]

#: kernel launches since the count was last set to 0
launches = 0

MAX_OBJECTIVES = 8


def dominance_counts_plain(y: torch.Tensor) -> torch.Tensor:
    """The [N, N, m] broadcast form (``dominance_counts_xla``)."""
    le = torch.all(y[:, None, :] <= y[None, :, :], dim=-1)  # le[q, p]: q <= p
    lt = torch.any(y[:, None, :] < y[None, :, :], dim=-1)
    return torch.sum(le & lt, dim=0, dtype=torch.int32)


def dominance_counts(y: torch.Tensor) -> torch.Tensor:
    global launches
    check_tensor("y", y, 2)
    if on_cpu(y):
        return dominance_counts_plain(y)
    n, m = y.shape
    if not 0 < m <= MAX_OBJECTIVES:
        raise ValueError(f"pareto_count: 1..{MAX_OBJECTIVES} objectives "
                         f"supported, got {m}")
    out = torch.empty((n,), dtype=torch.int32, device=y.device)
    if n == 0:
        return out
    err = build.library().pareto_count_launch(
        y.data_ptr(), out.data_ptr(), n, m, build.stream_ptr(y))
    build.check(err, "pareto_count")
    launches += 1
    return out
