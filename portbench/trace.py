"""The benchmark's own spans, and the device trace of a ``--trace 1`` run.

Spans are host-clock intervals (``time.time_ns``, the profiler's clock)
that the harness records around its calls into the program: a batch
handed to ``Engine.generate``, the engine's ``prefill`` and ``decode``
stages, a training step. The device trace is ``torch.profiler`` over the
measured window, with CUDA activity only (the card's kernels, copies and
sets, and the runtime calls that launched them); :func:`reduce` turns it
into arrays the metric readers take, with every time in seconds from the
window's start.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np


class Spans:
    """Named host intervals, in order of their start."""

    def __init__(self):
        self.items: list[tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0, time.time_ns()))


@contextlib.contextmanager
def device_trace(enabled: bool):
    """``torch.profiler`` over the block when ``enabled`` (yields the
    profiler, or None)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def reduce(prof, t0_ns: int, t1_ns: int) -> dict:
    """The device events of ``prof`` as arrays: ``names`` (unique), and per
    event ``idx`` (into names), ``start``/``end`` (seconds from ``t0_ns``)
    and ``launch`` (when the host launched it, from the runtime call of the
    same correlation id; NaN where none was traced); ``window_s``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    launch_at, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            dev.append(e)
        elif e.correlation_id():
            launch_at[e.correlation_id()] = e.start_ns()
    names, index = [], {}
    idx = np.empty(len(dev), np.int32)
    start = np.empty(len(dev))
    end = np.empty(len(dev))
    launch = np.full(len(dev), np.nan)
    for i, e in enumerate(dev):
        n = e.name()
        if n not in index:
            index[n] = len(names)
            names.append(n)
        idx[i] = index[n]
        s = e.start_ns()
        start[i] = (s - t0_ns) * 1e-9
        end[i] = (s + e.duration_ns() - t0_ns) * 1e-9
        at = launch_at.get(e.correlation_id())
        if at is not None:
            launch[i] = (at - t0_ns) * 1e-9
    return {"names": names, "idx": idx, "start": start, "end": end,
            "launch": launch, "window_s": (t1_ns - t0_ns) * 1e-9}


def busy_intervals(tr: dict) -> np.ndarray:
    """The union of the device events' intervals inside the window, as
    sorted disjoint [start, end] rows."""
    lo, hi = 0.0, tr["window_s"]
    s = np.clip(tr["start"], lo, hi)
    e = np.clip(tr["end"], lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    out = []
    for a, b in zip(s, e):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out).reshape(-1, 2)


def busy_s(tr: dict) -> float:
    iv = busy_intervals(tr)
    return float(np.sum(iv[:, 1] - iv[:, 0]))


def kernel_mask(tr: dict, pattern: str) -> np.ndarray:
    """Events whose name matches the regex ``pattern``."""
    import re

    hit = np.array([bool(re.search(pattern, n)) for n in tr["names"]], bool)
    return hit[tr["idx"]] if len(hit) else np.zeros(0, bool)


def in_spans(times: np.ndarray, spans, name: str) -> np.ndarray:
    """Which of ``times`` fall inside a span called ``name``."""
    out = np.zeros(times.shape, bool)
    for n, a, b in spans:
        if n == name:
            out |= (times >= a) & (times <= b)
    return out


def breakdown(tr: dict, spans) -> dict:
    """The ten device operations that took the most time, and the ten
    longest idle gaps of the window, each named by the innermost span the
    host was in at the gap's middle ("harness" outside every span)."""
    dur = tr["end"] - tr["start"]
    total = np.bincount(tr["idx"], weights=dur, minlength=len(tr["names"]))
    top = np.argsort(-total)[:10]
    ops = [[tr["names"][i], float(total[i])] for i in top if total[i] > 0]
    iv = busy_intervals(tr)
    edges = np.concatenate([[0.0], iv.ravel(), [tr["window_s"]]]).reshape(-1, 2)
    gaps = edges[:, 1] - edges[:, 0]
    idle = []
    for g in np.argsort(-gaps)[:10]:
        if gaps[g] <= 0:
            break
        mid = 0.5 * (edges[g, 0] + edges[g, 1])
        label = "harness"
        for n, a, b in spans:
            if a <= mid <= b and (label == "harness" or b - a <= width):
                label, width = n, b - a
        idle.append([label, float(gaps[g])])
    return {"device_ops": ops, "idle_gaps": idle}
