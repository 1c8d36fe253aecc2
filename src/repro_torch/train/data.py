"""Deterministic, stateless synthetic data: ``repro.train.data`` on
PyTorch.

Batch ``k`` is a pure function of ``(seed, k, host_id)``: its draws come
from a ``torch.Generator`` seeded from those three numbers alone, so there
is no pipeline state to checkpoint, and a resumed run regenerates batch
``k`` bit for bit. The data is a fixed random bigram language (each token
has ``branch`` successors drawn once from the seed, chosen with Zipf-ish
weights), so training has a floor to descend to, the bigram entropy
(:func:`bigram_entropy`). The draws are the generator's, not JAX's
threefry ones: the same config gives other tokens than the reference (the
parity tests hand the reference's tokens to both sides).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DataConfig", "make_batch", "bigram_entropy"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int            # tokens per example, +1 for the label shift
    global_batch: int
    seed: int = 0
    branch: int = 4         # successors per token


def _generator(*words: int) -> torch.Generator:
    """A CPU generator seeded from ``words`` alone (their SeedSequence
    hash)."""
    seed = np.random.SeedSequence([int(w) for w in words]).generate_state(
        2, np.uint32)
    return torch.Generator().manual_seed(int(seed[0]) << 32 | int(seed[1]))


def _succ_table(cfg: DataConfig) -> torch.Tensor:
    """[V, branch] fixed successor table (int64, from the seed)."""
    return torch.randint(0, cfg.vocab, (cfg.vocab, cfg.branch),
                         generator=_generator(cfg.seed))


def _branch_probs(cfg: DataConfig) -> torch.Tensor:
    """The successors' weights 1/(1 + i), normalized (float32)."""
    w = 1.0 / (1.0 + torch.arange(cfg.branch, dtype=torch.float32))
    return w / w.sum()


def make_batch(cfg: DataConfig, step: int, host_id: int = 0,
               n_hosts: int = 1, device=None) -> dict:
    """Tokens [global_batch / n_hosts, seq_len + 1] (int64) of this host
    at this step: a uniform first token, then each next one a successor of
    the last drawn by the branch weights. Drawn on the CPU and moved to
    ``device`` (default: the CPU), so every device sees the same tokens."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"make_batch: {n_hosts} hosts do not divide the "
                         f"batch {cfg.global_batch}")
    b = cfg.global_batch // n_hosts
    gen = _generator(cfg.seed + 1, int(step), host_id)
    first = torch.randint(0, cfg.vocab, (b,), generator=gen)
    choices = torch.multinomial(_branch_probs(cfg), b * cfg.seq_len,
                                replacement=True, generator=gen
                                ).view(b, cfg.seq_len)
    succ = _succ_table(cfg)
    tokens = torch.empty((b, cfg.seq_len + 1), dtype=torch.int64)
    tokens[:, 0] = cur = first
    for t in range(cfg.seq_len):
        cur = succ[cur, choices[:, t]]
        tokens[:, t + 1] = cur
    return {"tokens": tokens if device is None else tokens.to(device)}


def bigram_entropy(cfg: DataConfig) -> float:
    """Entropy of the generating bigram distribution (the CE floor), in
    float32 as the reference computes it."""
    p = _branch_probs(cfg)
    return float(-torch.sum(p * torch.log(p)))
