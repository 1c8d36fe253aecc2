"""SoC-Tuner on PyTorch and CUDA (NVIDIA Hopper).

A port of the exact-mode exploration path of :mod:`repro` (the JAX
reference package): the TABLE I design space, the VLSI-flow surrogate,
ICD importance, TED initialization, the GP surrogates, the IMOO
acquisition, the exact ``BOEngine`` and ``soc_tuner`` (Algorithm 3).

Three kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/``) and
built with ``nvcc`` at first use:

- ``kernels.systolic_eval``  the SoC cost model, one thread per design;
- ``kernels.pairdist``       tiled pairwise squared distances (+ fused RBF);
- ``kernels.pareto_count``   strict-dominance counts.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises. Every entry point runs on
``cuda`` unless the caller passes ``device="cpu"``. Randomness comes from
an explicit draws object (:mod:`repro_torch.random`).

This package imports ``torch`` and ``numpy`` only.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
