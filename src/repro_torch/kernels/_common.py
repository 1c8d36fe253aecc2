"""Argument checks and the launch-count lock shared by the kernel wrappers."""
from __future__ import annotations

import threading

import torch

#: held while a wrapper adds a launch to its counts (or while they are set
#: to 0): a flow pool's worker threads launch K1 concurrently, and a
#: read-modify-write of a module global is not atomic across threads
COUNT_LOCK = threading.Lock()


def check_tensor(name: str, t: torch.Tensor, ndim: int,
                 dtype: torch.dtype = torch.float32) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")


def on_cpu(*ts: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version runs), False
    when all lie on one CUDA device (the kernel runs); raise otherwise."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        # the launch goes to the current device; its pointers must live there
        raise ValueError(f"tensors on {dev} but the current CUDA device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return False
