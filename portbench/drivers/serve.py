"""The ``serve`` kind: a closed loop of one client that hands batches of
prompts to ``repro_torch.serve.Engine.generate`` (greedy) one after
another for the window, then judges a sample of the served tokens against
the plain reference.

A mix of this kind gives ``batch``, ``prompt_len``, ``new_tokens``,
``max_len``, ``warmup_batches`` and ``warmup_new_tokens``; the cell's file
gives ``check_requests`` (how many served requests the reference judges)
and the ``limits`` of the numbers it compares (:func:`stats`). Records:
each batch's submit, first-token and last-token times (seconds from the
window's start, host clock), the spans of ``generate`` and of the engine's
``prefill`` and ``decode`` stages.
"""
from __future__ import annotations

import gc
import random
import time

import torch

from .. import program, weights
from ..reference.common import strict_float32
from ..reference.model import served_logits
from ..trace import Spans, device_trace, reduce


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(ctx) -> dict:
    from repro_torch.serve import Engine, ServeConfig

    s, mix, dev, seed = ctx.sizes, ctx.mix, ctx.device, ctx.seed
    B, S0, n = mix["batch"], mix["prompt_len"], mix["new_tokens"]
    cfg = program.arch(ctx.config, s)
    engine = Engine(cfg, program.serving_model(cfg, s, seed, dev),
                    ServeConfig(max_len=mix["max_len"]))
    spans = Spans()
    first = {}
    fault = getattr(ctx, "serve_fault", None)

    def hook(name, fn, *args, **kw):
        with spans(name):
            out = fn(*args, **kw)
            if name == "prefill":          # the batch's first tokens on the host
                out[1].argmax(-1).cpu()
                first["t"] = time.time_ns()
        return out

    def batch(i, steps=n):
        toks = weights.tokens(dev, seed, "prompt", i, (B, S0), s.vocab)
        _sync(dev)
        t_sub = time.time_ns()
        with spans("generate"):
            out = engine.generate(toks, steps, timed=hook).cpu()
        if fault is not None:
            out = fault(out)
        return out, t_sub, first["t"], time.time_ns()

    # the cell's shapes: the prefill's and the decode step's (its cache is
    # max_len slots whatever the position), so a few new tokens do
    for i in range(mix["warmup_batches"]):
        batch(-1 - i, mix["warmup_new_tokens"])
    _sync(dev)
    setup_s = time.perf_counter() - ctx.t0
    spans.items.clear()
    done, served = [], []
    with device_trace(ctx.trace) as prof:
        t0 = time.time_ns()
        while time.time_ns() - t0 < ctx.seconds * 1e9:
            out, t_sub, t_first, t_last = batch(len(done))
            done.append((t_sub, t_first, t_last))
            served.append(out)
        t1 = time.time_ns()
    rel = lambda t: (t - t0) * 1e-9  # noqa: E731
    rec = {"setup_s": setup_s, "window_s": rel(t1),
           "batches": [{"requests": B, "prompt_len": S0, "new_tokens": n,
                        "t_submit": rel(a), "t_first": rel(b), "t_last": rel(c)}
                       for a, b, c in done],
           "spans": [(nm, rel(a), rel(b)) for nm, a, b in spans.items],
           "attempted": B * len(done), "failed": 0}
    rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    if prof is not None:
        rec["trace"] = reduce(prof, t0, t1)
        del prof
    del engine
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rec["checks"], rec["check_detail"] = check(ctx, served)
    rec["check_detail"]["check_s"] = time.perf_counter() - t
    return rec


def sample(ctx, n_batches: int) -> list[tuple[int, list[int]]]:
    """The requests the reference judges, drawn from the seed: (batch,
    rows) pairs. A MoE layer's capacity couples a batch's rows, so a MoE
    configuration is judged by whole batches."""
    B = ctx.mix["batch"]
    want = ctx.cell["check_requests"]
    rng = random.Random(weights.stream_seed(ctx.seed, "check"))
    if ctx.sizes.experts:
        picks = rng.sample(range(n_batches), min(n_batches, -(-want // B)))
        return [(b, list(range(B))) for b in sorted(picks)]
    flat = rng.sample([(b, r) for b in range(n_batches) for r in range(B)],
                      min(want, n_batches * B))
    out: dict[int, list[int]] = {}
    for b, r in sorted(flat):
        out.setdefault(b, []).append(r)
    return sorted(out.items())


def gaps(ctx, served: list, precisions=("fp32",)) -> dict:
    """For each precision, the reference's logits at every served position
    of the sampled requests, reduced to gaps against the float32 logits:
    ``fp32``: by how much each served token's logit lies below the best;
    any other precision (the control): the same for the token that
    precision puts first."""
    s, mix, dev, seed = ctx.sizes, ctx.mix, ctx.device, ctx.seed
    B, S0 = mix["batch"], mix["prompt_len"]
    strict_float32()
    weight = lambda name: weights.leaf(  # noqa: E731
        s, seed, name, torch.bfloat16, dev).float()
    out = {p: [] for p in precisions}
    for b, rows in sample(ctx, len(served)):
        prompt = weights.tokens(dev, seed, "prompt", b, (B, S0), s.vocab)[rows]
        toks = served[b][rows].to(dev, torch.int64)
        seq = torch.cat([prompt, toks[:, :-1]], dim=1)
        ref = served_logits(s, weight, seq, S0, "fp32", ctx.cell.get("rows", 8))
        best = ref.amax(-1)
        for p in precisions:
            pick = toks if p == "fp32" else served_logits(
                s, weight, seq, S0, p, ctx.cell.get("rows", 8)).argmax(-1)
            got = torch.gather(ref, -1, pick[..., None])[..., 0]
            out[p].append((best - got).flatten().cpu())
        del ref
    return {p: torch.cat(v) for p, v in out.items()}


def stats(g: torch.Tensor) -> dict:
    """The numbers a cell may compare, of the gaps ``g``: the widest, the
    mean, and the share of served tokens that are not the reference's
    best."""
    return {"widest_gap": float(g.max()), "mean_gap": float(g.mean()),
            "flipped_share": float((g > 0).float().mean())}


def check(ctx, served: list):
    """The numbers the cell's ``limits`` name, each with its limit. With
    ``ctx.control`` the control is judged in the program's place: the gaps
    of the tokens that the reference in float8 puts first, at the positions
    of the same prompts and served tokens; the program's own readings go
    into the detail."""
    control = getattr(ctx, "control", False)
    both = gaps(ctx, served, ("fp32", "fp8") if control else ("fp32",))
    got = stats(both["fp8" if control else "fp32"])
    detail = dict(got, served_tokens=int(both["fp32"].numel()),
                  judged="control" if control else "program")
    if control:
        detail["program"] = stats(both["fp32"])
    return {k: (got[k], lim) for k, lim in ctx.cell["limits"].items()}, detail
