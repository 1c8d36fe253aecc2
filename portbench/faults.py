"""Faults planted under the timed path, for the tests and calibration
that show a run with them comes out not correct. Each is a key of the
driver's context: ``fault`` wraps the training step function,
``serve_fault`` wraps ``Engine.generate``'s result."""
from __future__ import annotations


def _unchanged(step_fn):
    """A step that returns its state unchanged (the loss still computed)."""
    def step(state, batch, ef):
        import torch
        from repro_torch.models import loss_fn

        with torch.no_grad():
            loss, metrics = loss_fn(step_fn.model, batch)
        return state, ef, dict(metrics, loss=loss)
    step.model = step_fn.model
    return step


def _half_batch(step_fn):
    """Half of the batch's rows left out: the loss and the gradient are
    the mean over the rest."""
    def step(state, batch, ef):
        t = batch["tokens"]
        return step_fn(state, {"tokens": t[: t.shape[0] // 2]}, ef)
    step.model = step_fn.model
    return step


def _altered_token(out):
    """A served token changed where it is produced: each request's first,
    the prefill's."""
    out = out.clone()
    out[:, 0] += 1
    return out


FAULTS = {"unchanged": {"fault": _unchanged},
          "half_batch": {"fault": _half_batch},
          "altered_token": {"serve_fault": _altered_token}}
