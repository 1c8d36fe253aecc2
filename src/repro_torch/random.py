"""Explicit randomness for Algorithm 3.

``soc_tuner`` draws at two sites: the prologue's ICD trial rows and, each
BO round, the frontier subset plus the standard normals of the joint
posterior samples. A :class:`TunerDraws` object supplies both, so a caller
can replay any stream (the parity tests replay ``jax.random``'s key
schedule through it). :class:`GeneratorDraws` is the default, backed by a
seeded ``torch.Generator``.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from .device import resolve_device

__all__ = ["TunerDraws", "GeneratorDraws"]


class TunerDraws(Protocol):
    def prologue(self, n_pool: int, n: int):
        """``min(n, n_pool)`` distinct pool rows for the ICD trials."""

    def round(self, n_pool: int, frontier_subset: int, m: int, s: int):
        """One BO round's draws: ``(sub_rows, eps)``.

        ``sub_rows`` holds ``frontier_subset`` distinct pool rows, or is
        ``None`` when ``n_pool <= frontier_subset`` (frontier sampling then
        runs over the whole pool); ``eps`` [m, q, s] are standard normals,
        with ``q`` the number of frontier candidates."""


class GeneratorDraws:
    """Draws from one ``torch.Generator`` seeded with ``seed`` on ``device``."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def _choice(self, n_pool: int, k: int) -> np.ndarray:
        perm = torch.randperm(n_pool, generator=self.gen, device=self.device)
        return perm[:k].cpu().numpy()

    def prologue(self, n_pool: int, n: int) -> np.ndarray:
        return self._choice(n_pool, min(n, n_pool))

    def round(self, n_pool: int, frontier_subset: int, m: int, s: int):
        sub = (self._choice(n_pool, frontier_subset)
               if n_pool > frontier_subset else None)
        q = n_pool if sub is None else len(sub)
        eps = torch.randn((m, q, s), generator=self.gen, device=self.device,
                          dtype=torch.float32)
        return sub, eps
