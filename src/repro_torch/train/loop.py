"""The training step and the fault-tolerant loop: ``repro.train.loop`` on
one device.

:func:`make_train_step` builds ``step_fn(state, batch, ef) -> (state, ef,
metrics)``: the float32 masters are copied into one compute ``LM`` (bf16
for every tensor of more than one dim, float32 norms: the reference's
``_cast_bf16``, and the layout the port's ``LM`` already has), the loss is
differentiated with respect to that copy (microbatches accumulate ``g/n``
in float32, in order), optionally compressed to int8 with error feedback
(``compress_grads``), and AdamW updates the masters in place. The
compute copy is allocated once, with ``make_train_step``, never a step; its
parameters require gradients, while a serving ``LM``'s do not. The
reference's ``_constrain_compute_copy`` pins the copy's sharding on a mesh;
on one device it has nothing to do, and the ZeRO-1 gradient constraints
likewise (ROADMAP queue 1, item 14b.8).

On CUDA, attention runs K5 forward and backward (``kernels.flash_attn``);
on the CPU the plain versions, under autograd.

:func:`train` drives it: resume from ``ckpt_dir`` when it holds a
checkpoint, an asynchronous checkpoint every ``ckpt_every`` steps, the
``preempt_after`` drill (raises mid-run as a SIGTERM handler would, then
writes the state it reached), batches regenerated from their step alone,
so a resumed run equals an uninterrupted one bit for bit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import LM, check_ported, loss_fn
from repro_torch.parallel.collectives import ef_update, init_error_feedback
from .checkpoint import AsyncCheckpointer, latest_step, restore
from .data import DataConfig, make_batch
from .optimizer import (LRSchedule, TrainState, adamw_init, adamw_update,
                        cosine_lr)

__all__ = ["TrainConfig", "make_train_step", "train", "init_params"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    microbatch: int = 0          # micro-batches per step (0/1 = none)
    lr: LRSchedule = LRSchedule()
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    compress_grads: bool = False
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10


@torch.no_grad()
def init_params(cfg, generator: torch.Generator, device=None
                ) -> dict[str, torch.Tensor]:
    """Float32 master weights for ``cfg``, keyed by the ``LM``'s parameter
    names and drawn from ``generator`` by the serving ``init``'s rules in
    float32 (the reference's ``init``: masters in float32), on ``device``
    (default: CUDA)."""
    model = LM(cfg, device)
    for p in model.parameters():  # swap each bf16 tensor for a float32 one
        p.data = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    model.reset_parameters(generator)
    return {name: p.data for name, p in model.named_parameters()}


def _compute_copy(cfg, device) -> LM:
    model = LM(cfg, device)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def make_train_step(cfg, tcfg: TrainConfig, device=None) -> Callable:
    """``step_fn(state, batch, ef) -> (state, ef, metrics)`` for every
    family of the registry (``check_ported``). ``batch`` holds ``tokens``
    and, for an encoder-decoder, ``frames`` [B, enc_len, d]; it may hold
    ``images`` (a vision config); every key is split with the tokens into
    microbatches.
    ``ef`` is the error-feedback residual (None when ``compress_grads`` is
    off); ``metrics`` holds 0-d tensors ``ce``, ``aux``, ``loss`` and
    ``lr``. The state is updated in place. ``step_fn.model`` is the
    compute copy."""
    check_ported(cfg)
    dev = resolve_device(device)
    model = _compute_copy(cfg, dev)
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def grad_of(batch):
        loss, metrics = loss_fn(model, batch)
        return loss, metrics, torch.autograd.grad(loss, params)

    def step_fn(state: TrainState, batch: dict, ef):
        with torch.no_grad():
            for n, p in zip(names, params):  # the compute copy
                p.copy_(state.params[n])
        n = tcfg.microbatch
        if n and n > 1:
            mb = {k: t.reshape((n, t.shape[0] // n) + t.shape[1:])
                  for k, t in batch.items()}
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
            losses, metricses = [], []
            for i in range(n):
                loss, metrics, g = grad_of({k: t[i] for k, t in mb.items()})
                with torch.no_grad():
                    for a, gi in zip(acc, g):
                        a.add_(gi.to(torch.float32) / n)
                losses.append(loss.detach())
                metricses.append({k: v.detach() for k, v in metrics.items()})
            grads = dict(zip(names, acc))
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        else:
            loss, metrics, g = grad_of(batch)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
            # kept in bf16: adamw_update casts each leaf to float32 where it
            # uses it (the same values as casting all first, and at full
            # width no float32 copy of every gradient)
            grads = dict(zip(names, g))
            del g
        if tcfg.compress_grads:
            grads, ef = ef_update({k: t.to(torch.float32)
                                   for k, t in grads.items()}, ef)
        lr = cosine_lr(tcfg.lr, state.step)
        state = adamw_update(state, grads, lr, wd=tcfg.weight_decay,
                             clip=tcfg.grad_clip)
        return state, ef, dict(metrics, loss=loss, lr=lr)

    step_fn.model = model
    return step_fn


def train(cfg, tcfg: TrainConfig, data_cfg: DataConfig,
          init_params_fn: Callable[[], dict], preempt_after: Optional[int] = None,
          verbose: bool = True, device=None) -> tuple[TrainState, list[dict]]:
    """``repro.train.loop.train`` on ``device`` (default: CUDA):
    ``init_params_fn()`` gives the float32 masters (:func:`init_params`, or
    a reference state through ``convert``), on ``device``. Resumes from
    ``tcfg.ckpt_dir`` when it holds a checkpoint. Returns (the final state,
    the history: a record ``{"step", "ce", "aux", "loss", "lr",
    "wall_s"}`` every ``log_every`` steps and at the last). An
    encoder-decoder is refused (``ValueError``): its loss reads frames,
    which the bigram stream does not hold (the reference's ``train`` feeds
    ``make_batch``'s tokens alone too); :func:`make_train_step` trains it
    on batches that carry them."""
    check_ported(cfg)
    if cfg.is_encdec:
        raise ValueError(f"train: {cfg.arch_id} needs frames [B, "
                         f"{cfg.enc_len}, {cfg.d_model}] in every batch, and "
                         "the bigram stream holds tokens only; give "
                         "make_train_step batches with frames")
    dev = resolve_device(device)
    state = adamw_init(init_params_fn())
    ef = init_error_feedback(state.params) if tcfg.compress_grads else None
    start = 0
    ck = AsyncCheckpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    if tcfg.ckpt_dir and latest_step(tcfg.ckpt_dir) is not None:
        state, manifest = restore(tcfg.ckpt_dir, state, device=dev)
        start = int(manifest["step"])
        if verbose:
            print(f"[train] resumed from step {start}")

    step_fn = make_train_step(cfg, tcfg, dev)
    history: list[dict] = []
    t0 = time.time()
    try:
        for k in range(start, tcfg.steps):
            batch = make_batch(data_cfg, k, device=dev)
            state, ef, metrics = step_fn(state, batch, ef)
            if preempt_after is not None and k + 1 >= preempt_after:
                raise KeyboardInterrupt(f"simulated preemption at step {k + 1}")
            if (k + 1) % tcfg.log_every == 0 or k + 1 == tcfg.steps:
                rec = {"step": k + 1,
                       **{kk: float(vv) for kk, vv in metrics.items()},
                       "wall_s": time.time() - t0}
                history.append(rec)
                if verbose:
                    print(f"[train] step {rec['step']:5d} "
                          f"loss={rec['loss']:.4f} lr={rec['lr']:.2e}")
            if ck and (k + 1) % tcfg.ckpt_every == 0:
                ck.submit(k + 1, state)
    except KeyboardInterrupt:
        if ck:
            ck.submit(int(state.step), state)
            ck.wait()
        if verbose:
            print(f"[train] preempted at step {int(state.step)}; "
                  f"checkpoint written")
        return state, history
    if ck:
        ck.submit(tcfg.steps, state)
        ck.wait()
    return state, history
