"""Explicit randomness for Algorithm 3.

``soc_tuner`` draws at three sites: the prologue's ICD trial rows; each BO
round, the frontier subset plus the standard normals of the joint posterior
samples; and, with the between-round proposer on, each proposal try's parent
picks and perturbations. ``icd`` draws its trial designs from the space, and
a baseline (``core.baselines``) draws the seed of its numpy generator. A
:class:`TunerDraws` object supplies all of them,
so a caller can replay any stream (the parity tests replay ``jax.random``'s
key schedule through it). :class:`GeneratorDraws` is the default, backed by
seeded ``torch.Generator`` objects.

A draws object's ``state_dict`` goes into a run's checkpoint, and
``load_state_dict`` puts a resumed run's draws where the cut run's were.
"""
from __future__ import annotations

from typing import Protocol

import numpy as np
import torch

from .device import resolve_device

__all__ = ["TunerDraws", "GeneratorDraws", "PROPOSER_FOLD"]

#: tag that separates the proposer's draws from every other stream (the
#: reference's ``fold_in`` tag, "PROP")
PROPOSER_FOLD = 0x50524F50


class TunerDraws(Protocol):
    def prologue(self, n_pool: int, n: int):
        """``min(n, n_pool)`` distinct pool rows for the ICD trials."""

    def round(self, n_pool: int, frontier_subset: int, m: int, s: int):
        """One BO round's draws: ``(sub_rows, eps)``.

        ``sub_rows`` holds ``frontier_subset`` distinct pool rows, or is
        ``None`` when ``n_pool <= frontier_subset`` (frontier sampling then
        runs over the whole pool); ``eps`` [m, q, s] are standard normals,
        with ``q`` the number of frontier candidates."""

    def propose(self, it: int, t: int, draw: int, p: int, d: int):
        """Try ``t`` of the proposal after round ``it``: ``(picks, eps)``,
        ``picks`` [draw] int64 parent indices in ``[0, p)`` and ``eps``
        [draw, d] float32 standard normals. These draws never advance the
        ``round`` stream."""

    def designs(self, space, n: int):
        """``n`` index vectors [n, d] (int64 numpy) drawn uniformly from
        ``space``, its pins honored: Algorithm 1's trial designs."""

    def baseline_seed(self) -> int:
        """The seed in ``[0, 2**31 - 1)`` of a baseline's numpy generator."""

    def state_dict(self) -> dict:
        """The draws' position as a dict of numpy arrays (a checkpoint's
        ``"draws"`` entry)."""

    def load_state_dict(self, d: dict) -> None:
        """Continue from a :meth:`state_dict`."""


class GeneratorDraws:
    """Draws from ``torch.Generator`` objects on ``device``: the prologue's
    and the rounds' from one seeded with ``seed``, the proposer's from a
    second seeded from ``(seed, PROPOSER_FOLD)``, so a run's round draws do
    not depend on whether the proposer is on."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))
        self.prop_gen = torch.Generator(device=self.device)
        self.prop_gen.manual_seed((int(seed) << 32) ^ PROPOSER_FOLD)

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

    def propose(self, it: int, t: int, draw: int, p: int, d: int):
        # ``it`` and ``t`` order the calls; the second generator's stream
        # already follows that order
        picks = torch.randint(0, p, (draw,), generator=self.prop_gen,
                              device=self.device)
        eps = torch.randn((draw, d), generator=self.prop_gen,
                          device=self.device, dtype=torch.float32)
        return picks.cpu().numpy().astype(np.int64), eps.cpu().numpy()

    def designs(self, space, n: int) -> np.ndarray:
        return space.sample(self.gen, n).cpu().numpy()

    def baseline_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (), generator=self.gen,
                                 device=self.device))

    def state_dict(self) -> dict:
        """Both generators' ``get_state()`` as uint8 arrays (a CUDA
        generator's state is restored on a CUDA device)."""
        return {"gen": self.gen.get_state().numpy().copy(),
                "prop_gen": self.prop_gen.get_state().numpy().copy()}

    def load_state_dict(self, d: dict) -> None:
        for name in ("gen", "prop_gen"):
            getattr(self, name).set_state(torch.from_numpy(
                np.array(d[name], np.uint8)))
