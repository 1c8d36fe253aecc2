"""The per-round progress helper of the exploration drivers.

:func:`log_progress` appends the history record that
:func:`repro_torch.core.tuner.round_record` builds, optionally prints the
progress line in the reference's format, and, given an event log, emits the
matching ``round`` instant (``repro.obs.progress.log_progress``'s record), so
the on-disk timeline and the in-memory history never disagree. The event
adds nothing to the record: histories are the same with telemetry on or off.
"""
from __future__ import annotations

__all__ = ["log_progress"]


def log_progress(history: list, y, n_evaluated: int, i: int,
                 reference_front=None, *, verbose: bool = False,
                 tag: str = "soc-tuner", label: str | None = None,
                 word: str = "round", wall_s: float | None = None,
                 events=None, track: str | None = None, device=None,
                 **event_fields) -> dict:
    """Append round ``i``'s record to ``history`` and return it.

    The progress line starts with ``[tag]`` and, for a fleet's scenario or
    a server's job, its ``label``; ``word`` names the step (``"eval"`` for
    the service's evaluations). ``events`` is an
    :class:`repro_torch.obs.events.EventLog` or None; ``track`` defaults to
    the label, else the tag. Extra keyword fields ride on the event only.
    The front is decided on ``device``."""
    from repro_torch.core.tuner import round_record

    rec = round_record(y, n_evaluated, i, reference_front, wall_s=wall_s,
                       device=device)
    history.append(rec)
    if verbose:
        head = f"[{tag}] " + ("" if label is None else f"{label:<24s} ")
        num = f"{i:4d}" if word == "eval" else f"{i:3d}"
        print(head + f"{word} {num} evals={rec['evaluations']:4d} "
              f"front={rec['pareto_size']:3d}"
              + (f" adrs={rec['adrs']:.4f}" if "adrs" in rec else ""))
    if events is not None:
        events.instant(
            "round", cat="progress",
            track=track if track is not None else (label or tag),
            round=i, evaluations=rec["evaluations"],
            pareto_size=rec["pareto_size"],
            **({"adrs": rec["adrs"]} if "adrs" in rec else {}),
            **({"wall_s": wall_s} if wall_s is not None else {}),
            **event_fields)
    return rec
