"""The flow runner: the callable ``idx -> metrics`` interface the tuner expects.

:class:`VLSIFlow` evaluates designs with the SoC model (``systolic_eval``
kernel on CUDA, its plain version on the CPU) and counts its invocations: the
tuner's budget accounting reads ``calls`` and ``evaluated``. It pickles
without its device buffer, so a worker process rebuilds it on unpickle.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.space import DesignSpace
from repro_torch.device import resolve_device
from repro_torch.kernels import systolic_eval as _systolic_eval

from .workloads import get_workload

__all__ = ["VLSIFlow"]


class VLSIFlow:
    def __init__(self, space: DesignSpace, workload: str = "resnet50",
                 device=None):
        self.space = space
        self.layers = get_workload(workload)
        self.device = resolve_device(device)
        self._layers_t = self._upload()
        self.calls = 0
        self.evaluated = 0

    def _upload(self) -> torch.Tensor:
        return torch.as_tensor(self.layers, dtype=torch.float32,
                               device=self.device).contiguous()

    # A device buffer does not pickle (and must not: a worker process owns
    # its own CUDA context) — rebuild it from the host copy on unpickle.
    def __getstate__(self) -> dict:
        d = self.__dict__.copy()
        del d["_layers_t"]
        d["device"] = str(self.device)
        return d

    def __setstate__(self, d: dict) -> None:
        self.__dict__.update(d)
        self.device = resolve_device(self.device)
        self._layers_t = self._upload()

    def __call__(self, idx: np.ndarray) -> np.ndarray:
        idx = np.atleast_2d(np.asarray(idx))
        self.calls += 1
        self.evaluated += idx.shape[0]
        vals = torch.as_tensor(self.space.values(idx), dtype=torch.float32,
                               device=self.device).contiguous()
        return _systolic_eval.soc_metrics(vals, self._layers_t).cpu().numpy()
