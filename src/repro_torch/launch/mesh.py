"""Production meshes (``repro.launch.mesh``).

Functions, never module-level constants: importing this module touches no
device. Shapes and axis names are the reference's:

- single pod: (16, 16) = 256 devices, axes (data, model);
- multi pod: (2, 16, 16) = 512 devices, axes (pod, data, model).

``pod`` and ``data`` carry data parallelism (the batch shards over both),
``model`` tensor and expert parallelism; ``pod`` is the slow inter-pod hop
that gradient compression (``repro_torch.parallel.collectives``) targets.
The meshes are built from the process's CUDA devices as the port's
:class:`~repro_torch.parallel.sharding.Mesh`; with fewer devices they
raise. A mesh of that size without the devices (a fake process group of
256 or 512 ranks) is the sharded LM program's dry run, ROADMAP queue 1,
item 14b.9.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.sharding import Mesh

__all__ = ["make_production_mesh", "make_mesh_named"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have {have} CUDA "
            "devices; the mesh without its devices is the sharded LM "
            "program's dry run over a fake process group of that many "
            "ranks (ROADMAP queue 1, item 14b.9)")
    devs = np.empty(n, dtype=object)
    for i in range(n):
        devs[i] = torch.device("cuda", i)
    return Mesh(devs.reshape(shape), axes)


def make_mesh_named(name: str) -> Mesh:
    if name in ("single", "single_pod", "pod"):
        return make_production_mesh(multi_pod=False)
    if name in ("multi", "multi_pod", "2pod"):
        return make_production_mesh(multi_pod=True)
    raise KeyError(name)
