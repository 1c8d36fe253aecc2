"""SoC-Tuner on PyTorch and CUDA (NVIDIA Hopper).

A port of :mod:`repro` (the JAX reference package), slice by slice:

- the exploration path: the TABLE I design space, the VLSI-flow surrogate,
  ICD importance, TED initialization, the GP surrogates, the IMOO
  acquisition, the exact and incremental ``BOEngine`` and ``soc_tuner``
  (Algorithm 3), the fleet (``BatchedBOEngine``, ``fleet_tuner``), mutable
  pools and the between-round proposer, and checkpoints with resumed runs
  (``service.checkpoint``);
- the LM serving path for the dense GQA family (``configs``, ``models``,
  ``serve``, ``launch.serve``).

Five kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/``) and built
with ``nvcc`` at first use (:mod:`repro_torch.kernels`): ``systolic_eval``,
``pairdist``, ``pareto_count``, ``round_fused`` and ``flash_attn``.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor, or raises. Every entry point runs on
``cuda`` unless the caller passes ``device="cpu"``. Randomness comes from
an explicit draws object (:mod:`repro_torch.random`) or ``torch.Generator``.

This package imports ``torch`` and ``numpy`` only.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
