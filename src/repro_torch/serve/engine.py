"""Batched serving engine: prefill -> greedy decode over a preallocated
KV cache. A port of ``repro.serve.engine`` for the dense and MoE families,
GQA and MLA.

The prompt's prefill cache (GQA's K/V [L, B, S0, K, hd], or MLA's latent
[L, B, S0, kv_lora] and rope key [L, B, S0, rope]) is copied into the first
S0 slots of a zeroed decode cache of ``max_len`` slots, which every decode
step then updates in place. An MoE model's cache is the same: its blocks
differ from the dense ones only after the attention, and the leading dense
layers' caches sit in the one stack with the rest. Sliding-window configs (the reference's ring
placement, ``_ring_place``) are not ported and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import decode_step, init_cache, prefill

__all__ = ["ServeConfig", "Engine"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int = 256           # decode-cache capacity
    greedy: bool = True
    temperature: float = 1.0


def _untimed(name: str, fn, *args, **kwargs):
    return fn(*args, **kwargs)


class Engine:
    """``Engine(cfg, model, scfg)``: ``model`` an
    :class:`~repro_torch.models.LM` on the device that serves."""

    def __init__(self, cfg, model, scfg: ServeConfig = ServeConfig()):
        if cfg.window:
            raise NotImplementedError(
                f"repro_torch: the sliding-window ring cache ({cfg.arch_id}) "
                "is not yet ported (ROADMAP queue 1)")
        self.cfg = cfg
        self.scfg = scfg
        self.model = model

    # ------------------------------------------------------------ handoff
    def _merge_caches(self, dec, pre, s0: int):
        """Copy every field of the prefill cache (a ``KVCache`` or an
        ``MLACache``, [L, B, s0, ...]) into the first ``s0`` slots of
        ``dec``."""
        for d, p in zip(dec, pre):
            d[:, :, :s0] = p
        return dec

    # ------------------------------------------------------------ generate
    def generate(self, tokens: torch.Tensor, steps: int,
                 generator: Optional[torch.Generator] = None, *,
                 timed=_untimed) -> torch.Tensor:
        """``tokens`` [B, S0] prompt on the model's device. Returns the
        [B, steps] generations (int32). ``timed(name, fn, *args, **kw)``
        runs the stages "prefill" (once) and "decode" (each step) and returns
        what ``fn`` returns; the default just calls ``fn``."""
        B, S0 = tokens.shape
        if S0 + steps > self.scfg.max_len:
            raise ValueError(f"generate: {S0} prompt + {steps} new tokens "
                             f"exceed max_len={self.scfg.max_len}")
        pre, logits = timed("prefill", prefill, self.model, tokens)
        dec = init_cache(self.cfg, B, self.scfg.max_len, device=tokens.device)
        cache = self._merge_caches(dec, pre, S0)
        del pre

        outs = []
        tok = self._pick(logits, generator)
        for i in range(steps):
            outs.append(tok)
            cache, logits = timed("decode", decode_step, self.model, cache,
                                  tok, S0 + i)
            tok = self._pick(logits, generator)
        return torch.stack(outs, dim=1)

    def _pick(self, logits: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.scfg.greedy or generator is None:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
