"""Flow runners: the callable ``idx -> metrics`` interface the tuner expects.

:class:`VLSIFlow` evaluates designs with the SoC model (``systolic_eval``
kernel on CUDA, its plain version on the CPU) and counts its invocations: the
tuner's budget accounting reads ``calls`` and ``evaluated`` (exact under
concurrent worker threads). :class:`SimplifiedFlow` counts the same way but
evaluates the SCALE-Sim-like model that the paper shows misleading (Fig.
4(c)); it launches no kernel. :class:`DelayedFlow` wraps any flow with a
fixed sleep a call, the stand-in for an hours-long real VLSI flow in the
service's concurrency runs.

All pickle for ``spawn`` worker processes: :class:`VLSIFlow` drops its device
buffer and its lock, and a worker rebuilds them on unpickle (opening its own
CUDA context for a ``cuda`` flow; a worker without a card raises there).
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.core.space import DesignSpace
from repro_torch.device import resolve_device
from repro_torch.kernels import systolic_eval as _systolic_eval

from .simplified import simplified_metrics
from .workloads import get_workload

__all__ = ["VLSIFlow", "SimplifiedFlow", "DelayedFlow"]


class VLSIFlow:
    """``workload`` is a name (``soc.workloads.get_workload``) or a layer
    table [L, 5]."""

    def __init__(self, space: DesignSpace,
                 workload: str | np.ndarray = "resnet50", device=None):
        self.space = space
        self.layers = (get_workload(workload) if isinstance(workload, str)
                       else np.asarray(workload))
        self.device = resolve_device(device)
        self._layers_t = self._upload()
        self._lock = threading.Lock()
        self.calls = 0
        self.evaluated = 0

    def _upload(self) -> torch.Tensor:
        return torch.as_tensor(self.layers, dtype=torch.float32,
                               device=self.device).contiguous()

    # A device buffer does not pickle (and must not: a worker process owns
    # its own CUDA context) — rebuild it from the host copy on unpickle.
    def __getstate__(self) -> dict:
        d = self.__dict__.copy()
        del d["_layers_t"], d["_lock"]
        d["device"] = str(self.device)
        return d

    def __setstate__(self, d: dict) -> None:
        self.__dict__.update(d)
        self.device = resolve_device(self.device)
        self._layers_t = self._upload()
        self._lock = threading.Lock()

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        idx = np.atleast_2d(np.asarray(idx))
        with self._lock:
            self.calls += 1
            self.evaluated += idx.shape[0]
        vals = torch.as_tensor(self.space.values(idx), dtype=torch.float32,
                               device=self.device).contiguous()
        return self._model(vals, self._layers_t).cpu().numpy()

    def _model(self, vals: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
        """Designs [n, 26] on ``layers`` [L, 5] -> [n, 3], on the flow's
        device."""
        return _systolic_eval.soc_metrics(vals, layers)


class SimplifiedFlow(VLSIFlow):
    """:class:`VLSIFlow`'s interface and counts over the simplified model
    (``soc.simplified.simplified_metrics``, plain PyTorch on the flow's
    device)."""

    def _model(self, vals: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
        return simplified_metrics(vals, layers)


class DelayedFlow:
    """Any flow plus a fixed sleep a call: a mock of the real VLSI flow's
    hours per point. One call sleeps once however many rows it evaluates
    (a batch sent to a farm in parallel), so the service's one-design
    dispatches pay one delay each while q concurrent workers overlap theirs.
    A copy of ``repro.soc.flow.DelayedFlow``."""

    def __init__(self, flow, delay_s: float):
        self.flow = flow
        self.delay_s = float(delay_s)

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        time.sleep(self.delay_s)
        return self.flow(idx)
