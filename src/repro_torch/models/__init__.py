"""The LM serving substrate on PyTorch: every family of the registry — the
dense and MoE families (GQA and MLA), Mamba-2 (the ssm family), the RG-LRU
hybrid with sliding-window attention, the encoder-decoder (whisper) and
the vision frontend (pixtral's patch embeddings in the first slots).

``init`` builds an :class:`LM` from a generator; ``prefill`` /
``decode_step`` / ``init_cache`` drive it (see :mod:`.model`). Prefill
attention runs kernel K5 on CUDA: causal, with the config's window when it
has one, or bidirectional in the whisper encoder (see :mod:`.attention`);
cross-attention, SSD and the RG-LRU scan are plain torch on both devices,
as the reference computes them outside any kernel. ``loss_fn`` is the
training loss of every family (``check_ported`` refuses the rest), with
K5's backward kernel on CUDA under each of its masks; autograd
differentiates the plain-torch parts.
"""
from .model import (LM, EncDecCache, HybridCache, check_ported,
                    decode_step, init, init_cache, layer_kinds, loss_fn,
                    prefill, xent_chunks)
from .layers import rms_norm, rope
from .moe import MoE, moe_apply
from .rglru import RGLRU, LRUCache, init_lru_cache, rglru_apply
from .ssm import Mamba2, SSMCache, init_ssm_cache, mamba2_apply
from . import attention, moe, rglru, ssm

__all__ = ["LM", "HybridCache", "EncDecCache", "check_ported", "init",
           "prefill", "decode_step", "init_cache", "layer_kinds", "rms_norm",
           "loss_fn", "xent_chunks",
           "rope", "attention", "moe", "MoE", "moe_apply", "ssm", "Mamba2",
           "mamba2_apply", "SSMCache", "init_ssm_cache", "rglru", "RGLRU",
           "rglru_apply", "LRUCache", "init_lru_cache"]
