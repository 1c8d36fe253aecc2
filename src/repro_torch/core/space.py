"""SoC design space (paper TABLE I).

A design point is a vector of integer *candidate indices*, one per feature.
:meth:`DesignSpace.encode` maps index vectors to normalized float features
(log2-normalized numeric features, ordinal categoricals) used by every
distance-based algorithm (ICD, TED, GP). A copy of ``repro.core.space``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

__all__ = ["Feature", "DesignSpace", "TABLE_I", "make_space"]


@dataclasses.dataclass(frozen=True)
class Feature:
    """One row of TABLE I."""

    name: str
    values: tuple[float, ...]  # candidate values (categoricals use ordinal codes)
    group: str  # component group, for reporting (Fig. 5 grouping)
    categorical: bool = False

    @property
    def t(self) -> int:  # number of candidates (``t_i`` in Alg. 1)
        return len(self.values)


# Candidate tables, verbatim from TABLE I of the paper. Categorical codes:
#   HostCore: 0=c1 (LargeBoom), 1=c2 (LargeRocket), 2=c3 (MedRocket)
#   Dataflow: 0=WS, 1=OS, 2=BOTH
TABLE_I: tuple[Feature, ...] = (
    Feature("HostCore", (0, 1, 2), "cpu_l2", categorical=True),
    Feature("L2Bank", (1, 2, 4), "cpu_l2"),
    Feature("L2Way", (4, 8, 16), "cpu_l2"),
    Feature("L2Capa", (128, 256, 512), "cpu_l2"),  # KiB per bank
    Feature("TileRow", (1, 2, 4, 8), "systolic"),
    Feature("TileCol", (1, 2, 4, 8), "systolic"),
    Feature("MeshRow", (8, 16, 32, 64), "systolic"),
    Feature("MeshCol", (8, 16, 32, 64), "systolic"),
    Feature("Dataflow", (0, 1, 2), "systolic", categorical=True),
    Feature("InputType", (8, 16, 32), "systolic"),
    Feature("AccType", (8, 16, 32), "systolic"),
    Feature("OutType", (8, 20, 32), "systolic"),
    Feature("SpBank", (4, 8, 16, 32), "acc_mem"),
    Feature("SpCapa", (64, 128, 256, 512), "acc_mem"),  # rows per bank
    Feature("AccBank", (1, 2, 4, 8), "acc_mem"),
    Feature("AccCapa", (64, 128, 256, 512), "acc_mem"),  # rows per bank
    Feature("LdQueue", (2, 4, 8, 16), "controller"),
    Feature("StQueue", (2, 4, 8, 16), "controller"),
    Feature("ExQueue", (2, 4, 8, 16), "controller"),
    Feature("LdRes", (2, 4, 8, 16), "controller"),
    Feature("StRes", (2, 4, 8, 16), "controller"),
    Feature("ExRes", (2, 4, 8, 16), "controller"),
    Feature("MemReq", (16, 32, 64), "rocc"),
    Feature("DMABus", (32, 64, 128), "rocc"),  # bits
    Feature("DMABytes", (32, 64, 128), "rocc"),  # burst bytes
    Feature("TLBSize", (4, 8, 16), "rocc"),
)


class DesignSpace:
    """The (possibly pruned) cartesian design space over ``features``.

    ``pinned`` maps feature index -> pinned candidate index (Alg. 2 line 1:
    unimportant features are fixed to their median candidate).
    """

    def __init__(self, features: Sequence[Feature] = TABLE_I,
                 pinned: dict[int, int] | None = None):
        self.features = tuple(features)
        self.d = len(self.features)
        self.pinned = dict(pinned or {})
        self.t = np.array([f.t for f in self.features], dtype=np.int32)
        tmax = int(self.t.max())
        norm = np.zeros((self.d, tmax), dtype=np.float32)
        for i, f in enumerate(self.features):
            vals = np.asarray(f.values, dtype=np.float64)
            if f.categorical:
                x = vals / max(1.0, vals.max())
            else:
                lv = np.log2(np.maximum(vals, 1e-9))
                lo, hi = lv.min(), lv.max()
                x = (lv - lo) / max(hi - lo, 1e-9)
            norm[i, : f.t] = x
        self.norm_table = torch.from_numpy(norm)  # [d, tmax] float32, CPU

    @property
    def log10_size(self) -> float:
        """log10 of the number of design points in the (pruned) space."""
        return sum(math.log10(f.t) for i, f in enumerate(self.features)
                   if i not in self.pinned)

    def pruned_fraction(self, base: "DesignSpace | None" = None) -> float:
        """Fraction of design points removed relative to ``base`` (Alg. 2)."""
        base = base or DesignSpace(self.features)
        return 1.0 - 10.0 ** (self.log10_size - base.log10_size)

    def sample(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """Uniformly sample ``n`` index vectors [n, d] (int64) on the
        generator's device, honoring pins."""
        dev = generator.device
        cols = []
        for i, f in enumerate(self.features):
            if i in self.pinned:
                cols.append(torch.full((n,), self.pinned[i], dtype=torch.int64,
                                       device=dev))
            else:
                cols.append(torch.randint(0, f.t, (n,), generator=generator,
                                          device=dev))
        return torch.stack(cols, dim=1)

    def apply_pins(self, idx: torch.Tensor) -> torch.Tensor:
        """Project index vectors into the pruned space (pin columns)."""
        idx = idx.clone()
        for i, j in self.pinned.items():
            idx[..., i] = j
        return idx

    def encode(self, idx: torch.Tensor) -> torch.Tensor:
        """Index vectors [..., d] -> normalized float32 features [..., d] in
        [0, 1], on ``idx``'s device."""
        idx = torch.as_tensor(idx).long()
        table = self.norm_table.to(idx.device)
        cols = torch.arange(self.d, device=idx.device)
        return table[cols, idx]

    def snap(self, xn) -> torch.Tensor:
        """Normalized coordinates [..., d] -> the nearest lattice index
        vectors [..., d] (int64, on ``xn``'s device): the inverse of
        :meth:`encode` up to rounding. Each feature takes the candidate whose
        normalized value is nearest in float32 (a tie keeps the lower index);
        out-of-range coordinates clamp to the nearer end of the ladder."""
        xn = torch.as_tensor(xn, dtype=torch.float32)
        table = self.norm_table.to(xn.device)                    # [d, tmax]
        t = torch.as_tensor(self.t, device=xn.device)
        valid = torch.arange(table.shape[1], device=xn.device)[None, :] < t[:, None]
        dist = torch.abs(xn[..., None] - table)                  # [..., d, tmax]
        dist = torch.where(valid, dist, torch.full_like(dist, float("inf")))
        return torch.argmin(dist, dim=-1)  # the first of equal minima

    def values(self, idx: np.ndarray) -> np.ndarray:
        """Index vectors -> raw candidate values (float64), for the SoC model."""
        idx = np.asarray(idx)
        out = np.zeros(idx.shape, dtype=np.float64)
        for i, f in enumerate(self.features):
            out[..., i] = np.asarray(f.values)[idx[..., i]]
        return out

    def names(self) -> list[str]:
        return [f.name for f in self.features]

    def feature_index(self, name: str) -> int:
        return self.names().index(name)

    def prune(self, v: np.ndarray, v_th: float) -> "DesignSpace":
        """Alg. 2 line 1: pin features with importance below ``v_th`` to the
        median candidate."""
        v = np.asarray(v)
        pinned = dict(self.pinned)
        for i, f in enumerate(self.features):
            if i not in pinned and v[i] < v_th:
                pinned[i] = (f.t - 1) // 2  # medium(.) of the ordered candidates
        return DesignSpace(self.features, pinned)

    def describe(self) -> str:
        rows = []
        for i, f in enumerate(self.features):
            pin = (f" PINNED={f.values[self.pinned[i]]}" if i in self.pinned else "")
            rows.append(f"{f.name:<10s} {f.group:<10s} {f.values}{pin}")
        return "\n".join(rows)


def make_space() -> DesignSpace:
    """The full TABLE I space."""
    return DesignSpace(TABLE_I)
