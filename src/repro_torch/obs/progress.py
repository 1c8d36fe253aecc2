"""The per-round progress helper of the exploration drivers.

:func:`log_progress` appends the history record that
:func:`repro_torch.core.tuner.round_record` builds and optionally prints the
progress line, in the reference's format. The reference also writes an
event log; that part of ``repro.obs`` is not ported yet.
"""
from __future__ import annotations

__all__ = ["log_progress"]


def log_progress(history: list, y, n_evaluated: int, i: int,
                 reference_front=None, *, verbose: bool = False,
                 wall_s: float | None = None, device=None,
                 tag: str = "soc-tuner", label: str | None = None) -> dict:
    """Append round ``i``'s record to ``history`` and return it; the
    progress line starts with ``[tag]`` and, for a fleet's scenario, its
    ``label``."""
    from repro_torch.core.tuner import round_record

    rec = round_record(y, n_evaluated, i, reference_front, wall_s=wall_s,
                       device=device)
    history.append(rec)
    if verbose:
        head = f"[{tag}] " + ("" if label is None else f"{label:<24s} ")
        print(head + f"round {i:3d} evals={rec['evaluations']:4d} "
              f"front={rec['pareto_size']:3d}"
              + (f" adrs={rec['adrs']:.4f}" if "adrs" in rec else ""))
    return rec
