"""The exact BO engine: one scenario's surrogate + acquisition rounds.

A port of ``repro.core.engine.BOEngine(incremental=False)``: each round is
a cold ``fit_gp`` on every observation so far, IMOO scoring of the whole pool
with frontier sampling over ``sub_rows``, never-re-evaluate masking and a
host argmax (ties to the first index). The incremental engine (warm fits,
rank-k Cholesky updates, the ``round_fused`` kernel) is not ported yet
(ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .acquisition import imoo_scores
from .gp import fit_gp

__all__ = ["BOEngine", "EngineStats"]


@dataclasses.dataclass
class EngineStats:
    """Host-side counters for one engine run."""

    rounds: int = 0
    dispatches: int = 0  # round stages run (fit, posterior, frontier, predict, score)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class BOEngine:
    """Persistent surrogate + acquisition engine for one scenario::

        engine = BOEngine(pool_icd, gp_steps=150)
        engine.observe(init_rows, y_init)            # raw (minimized) metrics
        for _ in range(T):
            sub, eps = draws.round(N, 512, m, s)
            nxt = engine.select(eps, sub)            # one BO round
            engine.observe([nxt], flow(pool_idx[nxt][None]))

    The pool ``pool_icd`` [N, d] lives on its device; every round runs there.
    """

    #: round stages of one exact round (fit, posterior cache, frontier
    #: sampling, predict, scoring) — the ``dispatches`` counter's unit
    EXACT_DISPATCHES_PER_ROUND = 5

    def __init__(self, pool_icd: torch.Tensor, *, incremental: bool = False,
                 gp_steps: int = 150, s_frontiers: int = 10, weights=None):
        if incremental:
            raise NotImplementedError(
                "repro_torch: BOEngine(incremental=True) is not ported yet "
                "(ROADMAP queue 1, item 9); use incremental=False")
        self.pool = torch.as_tensor(pool_icd, dtype=torch.float32).contiguous()
        self.device = self.pool.device
        self.N, self.d = self.pool.shape
        self.gp_steps = int(gp_steps)
        self.s_frontiers = int(s_frontiers)
        self.weights = (None if weights is None else torch.as_tensor(
            np.asarray(weights), dtype=torch.float32, device=self.device))
        self.stats = EngineStats()
        self._rows: list[int] = []
        self._y: np.ndarray | None = None       # [k, m] raw minimized metrics

    def observe(self, rows, y) -> None:
        """Append flow evaluations: pool rows + raw (minimized) metrics."""
        rows = [int(r) for r in np.asarray(rows).reshape(-1)]
        y = np.atleast_2d(np.asarray(y, np.float32))
        if len(rows) != y.shape[0]:
            raise ValueError(f"observe: {len(rows)} rows but {y.shape[0]} metric rows")
        if not rows:
            return
        self._rows.extend(rows)
        self._y = y if self._y is None else np.concatenate([self._y, y], 0)

    @property
    def m(self) -> int:
        if self._y is None:
            raise RuntimeError("engine has no observations yet")
        return self._y.shape[1]

    def select(self, eps, sub_rows=None) -> int:
        """Run one BO round and return the next pool row to evaluate.

        ``eps`` [m, q, s] are the standard normals of the joint frontier
        draw over ``sub_rows`` (q rows; the whole pool when None)."""
        if self._y is None or not self._rows:
            raise RuntimeError("select() before observe(): nothing to fit")
        rows = np.asarray(self._rows)
        rows_t = torch.as_tensor(rows, device=self.device)
        state = fit_gp(self.pool[rows_t],
                       torch.as_tensor(-self._y, device=self.device),
                       steps=self.gp_steps)
        fc = (self.pool if sub_rows is None else
              self.pool[torch.as_tensor(np.asarray(sub_rows),
                                        device=self.device)].contiguous())
        eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        scores = imoo_scores(state, self.pool, eps, frontier_cand=fc,
                             weights=self.weights).cpu().numpy()
        scores[rows] = -np.inf  # never re-evaluate
        self.stats.rounds += 1
        self.stats.dispatches += self.EXACT_DISPATCHES_PER_ROUND
        return int(np.argmax(scores))

    def select_q(self, eps, q: int = 1, sub_rows=None) -> list[int]:
        """``q`` picks in one round; only ``q = 1`` is ported (fantasy
        q-batches need the incremental engine)."""
        if q != 1:
            raise NotImplementedError(
                "repro_torch: select_q with q > 1 needs the incremental "
                "engine, not ported yet (ROADMAP queue 1, item 9)")
        return [self.select(eps, sub_rows)]
