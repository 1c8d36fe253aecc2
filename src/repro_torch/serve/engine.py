"""Batched serving engine: prefill -> greedy decode over a preallocated
decode cache. A port of ``repro.serve.engine`` for every family.

The prefill's cache is handed to a zeroed decode cache of ``max_len``
positions (``init_cache``), field by field, as the reference's
``_merge_caches`` places them:

- a field of the decode cache's own shape is copied whole: the SSM and
  RG-LRU states (conv windows and recurrent states), which the prefill
  leaves final-shaped, an encoder-decoder's cross K/V (``enc_len``
  positions on both sides: ``prefill`` refuses frames of another length),
  and a K/V field whose prompt filled it exactly;
- a K/V field longer than a sliding-window ring (a prompt past the window)
  keeps its last ``window`` positions, position p at slot p % window
  (``_ring_place``);
- any other field (GQA's K/V [L, B, S0, K, hd], MLA's latent and rope key)
  goes into the first S0 slots.

Every decode step then updates the cache in place. An MoE model's cache is
a dense one's: its blocks differ only after the attention, and the leading
dense layers' caches sit in the one stack with the rest.
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


def _ring_place(dst: torch.Tensor, src: torch.Tensor, window: int,
                s0: int) -> torch.Tensor:
    """Write a [L, B, S0, ...] prefill K/V into a [L, B, window, ...] ring
    at slots p % window for its last ``window`` positions p."""
    S0 = src.shape[2]
    keep = min(window, S0)
    slots = torch.arange(S0 - keep, S0, device=dst.device) % window
    dst[:, :, slots] = src[:, :, S0 - keep:].to(dst.dtype)
    return dst


def _fields(cache):
    """The tensors of a cache (a NamedTuple, possibly of NamedTuples)."""
    for f in cache:
        if isinstance(f, tuple):
            yield from _fields(f)
        else:
            yield f


class Engine:
    """``Engine(cfg, model, scfg)``: ``model`` an
    :class:`~repro_torch.models.LM` on the device that serves."""

    def __init__(self, cfg, model, scfg: ServeConfig = ServeConfig()):
        self.cfg = cfg
        self.scfg = scfg
        self.model = model

    # ------------------------------------------------------------ handoff
    def _merge_caches(self, dec, pre, s0: int):
        """Place every field of the prefill cache ``pre`` into the decode
        cache ``dec`` (see the module docstring); returns ``dec``."""
        window = self.cfg.window
        for d, p in zip(_fields(dec), _fields(pre), strict=True):
            if d.shape == p.shape:
                d.copy_(p)
            elif window and p.shape[2] > d.shape[2]:
                _ring_place(d, p, window, s0)
            else:
                d[tuple(slice(0, n) for n in p.shape)] = p
        return dec

    # ------------------------------------------------------------ generate
    def generate(self, tokens: torch.Tensor, steps: int,
                 generator: Optional[torch.Generator] = None, *,
                 frames: Optional[torch.Tensor] = None,
                 images: Optional[torch.Tensor] = None,
                 timed=_untimed) -> torch.Tensor:
        """``tokens`` [B, S0] prompt on the model's device, with ``frames``
        (an encoder-decoder's) or ``images`` (a vision config's) handed to
        ``prefill``. Returns the [B, steps] generations (int32).
        ``timed(name, fn, *args, **kw)`` runs the stages "prefill" (once)
        and "decode" (each step) and returns what ``fn`` returns; the
        default just calls ``fn``."""
        B, S0 = tokens.shape
        window, max_len = self.cfg.window, self.scfg.max_len
        # a ring of the whole window never runs out; any other cache does
        # (the reference's decode writes past its end silently)
        if S0 + steps > max_len and not (window and max_len >= window):
            raise ValueError(f"generate: {S0} prompt + {steps} new tokens "
                             f"exceed max_len={max_len}")
        pre, logits = timed("prefill", prefill, self.model, tokens,
                            frames=frames, images=images)
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
