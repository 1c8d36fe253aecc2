"""The ``train`` kind: one training step object of
``repro_torch.train.make_train_step`` (its compute copy, the float32
masters and AdamW's moments) driven through its first ``check_steps``
steps in set-up, then through as many steps as the window holds, on
token rows drawn from the seed (every step's rows differ).

The first steps are what the reference follows: each step's loss, each
leaf's gradient as AdamW's first update took it (its first moment over
1 − β1) and each leaf's change over those steps. The window's steps are
enqueued without a synchronisation between them (the program's own
run-ahead), and the window ends when the last one has finished on the
card. A mix of this kind gives ``batch``, ``seq_len``, ``remat``,
``check_steps`` and the optimizer's settings (``optimizer``).
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import torch

from .. import program, weights
from ..reference.common import strict_float32
from ..reference.model import median_leaf_gap, train_readings, worst_leaf_gap
from ..trace import Spans, device_trace, reduce


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def batch(ctx, i: int) -> torch.Tensor:
    m = ctx.mix
    return weights.tokens(ctx.device, ctx.seed, "train", i,
                          (m["batch"], m["seq_len"] + 1), ctx.sizes.vocab)


def program_step(ctx):
    """(the step function, the state at step 0, the per-leaf initial
    masters' drawer) of the program."""
    from repro_torch.train import LRSchedule, TrainConfig, make_train_step
    from repro_torch.train.optimizer import adamw_init

    s, opt, dev = ctx.sizes, ctx.mix["optimizer"], ctx.device
    cfg = dataclasses.replace(program.arch(ctx.config, s), remat=ctx.mix["remat"])
    state = adamw_init(program.masters(cfg, s, ctx.seed, dev))
    tcfg = TrainConfig(lr=LRSchedule(base=opt["lr"], warmup=opt["warmup"],
                                     total=opt["total_steps"],
                                     min_ratio=opt["min_lr_ratio"]),
                       weight_decay=opt["weight_decay"], grad_clip=opt["grad_clip"])
    return make_train_step(cfg, tcfg, dev), state


def run(ctx) -> dict:
    s, mix, dev = ctx.sizes, ctx.mix, ctx.device
    opt = mix["optimizer"]
    if (opt["b1"], opt["b2"], opt["eps"]) != (0.9, 0.95, 1e-8):
        raise ValueError("the program's AdamW runs b1 0.9, b2 0.95, eps 1e-8")
    step_fn, state = program_step(ctx)
    fault = getattr(ctx, "fault", None)
    if fault is not None:
        step_fn = fault(step_fn)
    spans = Spans()
    got = {"loss": []}
    for i in range(mix["check_steps"]):
        state, _, m = step_fn(state, {"tokens": batch(ctx, i)}, None)
        got["loss"].append(float(m["loss"]))
        if i == 0:
            got["grad"] = {n: float(torch.linalg.vector_norm(t)) / (1 - opt["b1"])
                                for n, t in state.m.items()}
    with torch.no_grad():
        got["delta"] = {
            n: float(torch.linalg.vector_norm(
                p - weights.leaf(s, ctx.seed, n, torch.float32, dev)))
            for n, p in state.params.items()}
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    tokens = mix["batch"] * mix["seq_len"]
    steps = 0
    with device_trace(ctx.trace) as prof:
        t0 = time.time_ns()
        while time.time_ns() - t0 < ctx.seconds * 1e9:
            with spans("step"):
                state, _, _ = step_fn(state, {"tokens": batch(
                    ctx, mix["check_steps"] + steps)}, None)
            steps += 1
        with spans("drain"):
            _sync(dev)
        t1 = time.time_ns()
    rel = lambda t: (t - t0) * 1e-9  # noqa: E731
    rec = {"setup_s": setup_s, "window_s": rel(t1), "steps": steps,
           "tokens": steps * tokens, "batch": mix["batch"], "seq_len": mix["seq_len"],
           "spans": [(nm, rel(a), rel(b)) for nm, a, b in spans.items],
           "attempted": steps, "failed": 0}
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if prof is not None:
        rec["trace"] = reduce(prof, t0, t1)
        del prof
    del step_fn, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference(ctx)
    control = getattr(ctx, "control", False)
    # the control: the reference in float8, judged in the program's place
    judged = reference(ctx, "fp8") if control else got
    rec["checks"], rec["check_detail"] = compare(ctx, judged, ref)
    rec["check_detail"]["judged"] = "control" if control else "program"
    if control:
        rec["check_detail"]["program"] = readings(got, ref)[0]
    rec["check_detail"]["check_s"] = time.perf_counter() - t
    return rec


def reference(ctx, precision: str = "fp32") -> dict:
    """The reference's readings over the same first steps."""
    strict_float32()
    s, dev = ctx.sizes, ctx.device
    master = lambda n: weights.leaf(s, ctx.seed, n, torch.float32, dev)  # noqa: E731
    return train_readings(s, master,
                          [batch(ctx, i) for i in range(ctx.mix["check_steps"])],
                          ctx.mix["optimizer"], precision, ctx.mix["remat"])


def readings(got: dict, ref: dict) -> tuple[dict, dict]:
    """The numbers a cell may compare, and the leaves they came from: the
    largest gap of a step's loss; the first gradient's norm and the change
    over the steps, each by the worst leaf (``*_gap``) and by the median
    leaf (``*_gap_median``), the change over the leaves whose reference
    gradient is at least a thousandth of the median leaf's (a leaf with
    none moves by round-off alone)."""
    med = statistics.median(ref["grad"].values())
    moved = {n for n, g in ref["grad"].items() if g >= 1e-3 * med}
    grad_gap, grad_leaf = worst_leaf_gap(got["grad"], ref["grad"])
    delta_gap, delta_leaf = worst_leaf_gap(got["delta"], ref["delta"], moved)
    nums = {"loss_gap": max(abs(a - b) for a, b in zip(got["loss"], ref["loss"])),
            "grad_gap": grad_gap, "delta_gap": delta_gap,
            "grad_gap_median": median_leaf_gap(got["grad"], ref["grad"]),
            "delta_gap_median": median_leaf_gap(got["delta"], ref["delta"], moved)}
    return nums, {"grad_leaf": grad_leaf, "delta_leaf": delta_leaf,
                  "leaves_compared": len(moved)}


def compare(ctx, got: dict, ref: dict):
    """The numbers the cell's ``limits`` name, each with its limit, and
    the detail of every reading."""
    nums, leaves = readings(got, ref)
    detail = dict(nums, loss=got["loss"], ref_loss=ref["loss"], **leaves)
    return {k: (nums[k], lim) for k, lim in ctx.cell["limits"].items()}, detail
