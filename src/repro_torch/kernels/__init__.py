"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

- ``systolic_eval``  batched SoC cost model (replaces the Pallas
                     ``systolic_eval`` kernel)
- ``pairdist``       pairwise squared distances + fused RBF (Pallas ``pairdist``)
- ``pareto_count``   strict-dominance counts (Pallas ``pareto_count``)
- ``round_fused``    one incremental acquisition round over the chunked pool
                     (Pallas ``round_fused``)
- ``flash_attn``     attention of the LM prefill, causal or bidirectional
                     (Pallas ``flash_attn``): bf16 on the tensor cores,
                     float32 on the CUDA cores
- ``build``          ``nvcc`` build of ``csrc/`` into one ctypes-loaded library

A wrapper runs its plain version for CPU tensors only; for CUDA tensors it
launches the kernel or raises. Each keeps a plain-integer ``launches`` count,
added to under ``COUNT_LOCK`` so that launches from worker threads are all
counted. Counts are per process: a ``spawn`` worker's launches stay in it.
"""
from . import flash_attn, pairdist, pareto_count, round_fused, systolic_eval
from ._common import COUNT_LOCK

KERNELS = (systolic_eval, pairdist, pareto_count, round_fused, flash_attn)

__all__ = ["flash_attn", "pairdist", "pareto_count", "round_fused",
           "systolic_eval", "KERNELS", "reset_launches"]


def reset_launches() -> None:
    """Set every kernel's launch count (and its counts by route, class or
    shape) to 0."""
    with COUNT_LOCK:
        for k in KERNELS:
            k.launches = 0
            for by in ("route_launches", "class_launches"):
                counts = getattr(k, by, {})
                for key in counts:
                    counts[key] = 0
            for by in ("shape_launches", "multi_shape_launches"):
                getattr(k, by, {}).clear()
