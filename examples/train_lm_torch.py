"""End-to-end LM training on PyTorch: ~68M-parameter model, a few hundred
steps. The twin of ``examples/train_lm.py``.

Trains a narrowed qwen3-family model (qwen3-100m: 12 layers, d 512, 8/4
heads of 64, d_ff 1408, vocab 32064; qk_norm) on the synthetic bigram
stream, with checkpoints and, with ``--drill``, a preemption at a third of
the run and a resume from its checkpoint, and asserts that the loss falls
toward the bigram entropy floor. On the card by default (attention forward
and backward through kernel K5 at head dim 64), or with ``--device cpu``
on the plain PyTorch versions.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.train import (DataConfig, LRSchedule, TrainConfig,
                               bigram_entropy, init_params, train)


def qwen3_100m():
    """The example's config: qwen3-14b narrowed, as ``train_lm.py`` makes
    it."""
    return dataclasses.replace(
        get_config("qwen3-14b"), arch_id="qwen3-100m",
        n_layers=12, d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
        d_ff=1408, vocab=32064, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--drill", action="store_true",
                    help="preempt at 1/3 of the run, then resume")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = qwen3_100m()
    n = cfg.n_params()
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=0)
    floor = bigram_entropy(dcfg)
    print(f"[example] {cfg.arch_id}: {n/1e6:.1f}M params, "
          f"bigram CE floor {floor:.3f}, device {dev}")

    with tempfile.TemporaryDirectory() as ckpt:
        tcfg = TrainConfig(
            steps=args.steps, ckpt_dir=ckpt,
            ckpt_every=max(20, args.steps // 6),
            log_every=max(10, args.steps // 30),
            lr=LRSchedule(base=1e-3, warmup=args.steps // 10,
                          total=args.steps))

        def init_fn():
            return init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)

        if args.drill:
            print("[example] running preemption drill...")
            train(cfg, tcfg, dcfg, init_fn, preempt_after=args.steps // 3,
                  device=dev)
            print("[example] resuming from checkpoint...")
        _, hist = train(cfg, tcfg, dcfg, init_fn, device=dev)

    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[example] loss {first:.3f} -> {last:.3f} (floor {floor:.3f})")
    assert last < first, "training did not reduce the loss"
    print("[example] OK")


if __name__ == "__main__":
    main()
