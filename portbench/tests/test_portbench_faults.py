"""A run of each kind, with the harness's look for a card skipped, at the
program's smoke-twin sizes and under the committed cells' limits: a sound
run comes out correct; the control (the reference in float8 in the
program's place) and each fault a cell can have, planted under the timed
path, come out not correct. On the CPU, and again on the card (``cuda``
marker), where the program runs its CUDA kernels."""
import json
from pathlib import Path

import pytest
import torch

from portbench import faults
from portbench.drivers import serve, train

from smoke import DEEPSEEK, NEMO, SERVE_MIX, TRAIN_MIX, context

CELLS = Path(__file__).resolve().parents[1] / "cells"


def _cell(name: str, **over) -> dict:
    return dict(json.loads((CELLS / f"{name}.json").read_text()), **over)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device(request.param)


def _correct(rec: dict) -> bool:
    return all(v <= lim for v, lim in rec["checks"].values())


SERVE = [("nemo12b-prefill", NEMO), ("nemo12b-decode", NEMO)]


@pytest.mark.parametrize("cell,config", SERVE, ids=[c for c, _ in SERVE])
def test_serve_sound_control_and_altered_token(device, cell, config):
    # every request of the window judged, so the altered one is among them
    ctx = lambda **kw: context(config, SERVE_MIX, _cell(cell, check_requests=10**6),  # noqa: E731
                               device=device, **kw)
    sound = serve.run(ctx())
    assert _correct(sound), sound["checks"]
    control = serve.run(ctx(control=True))
    assert control["check_detail"]["judged"] == "control"
    assert not _correct(control), control["checks"]
    assert not _correct(serve.run(ctx(**faults.FAULTS["altered_token"])))


def test_train_sound_and_control(device):
    ctx = lambda **kw: context(DEEPSEEK, TRAIN_MIX, _cell("dsv2lite-train"),  # noqa: E731
                               device=device, **kw)
    sound = train.run(ctx())
    assert _correct(sound), sound["checks"]
    control = train.run(ctx(control=True))
    assert control["check_detail"]["judged"] == "control"
    assert not _correct(control), control["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_fault_is_not_correct(device, fault):
    ctx = context(DEEPSEEK, TRAIN_MIX, _cell("dsv2lite-train"), device=device,
                  **faults.FAULTS[fault])
    assert not _correct(train.run(ctx))
