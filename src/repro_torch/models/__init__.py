"""The LM serving substrate on PyTorch: the dense and MoE families, GQA and
MLA.

``init`` builds an :class:`LM` from a generator; ``prefill`` /
``decode_step`` / ``init_cache`` drive it (see :mod:`.model`). Causal
prefill attention runs kernel K5 on CUDA (see :mod:`.attention`).
"""
from .model import LM, check_ported, decode_step, init, init_cache, prefill
from .layers import rms_norm, rope
from .moe import MoE, moe_apply
from . import attention, moe

__all__ = ["LM", "check_ported", "init", "prefill", "decode_step",
           "init_cache", "rms_norm", "rope", "attention", "moe", "MoE",
           "moe_apply"]
