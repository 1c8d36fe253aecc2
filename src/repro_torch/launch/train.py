"""Training launcher: ``--arch <id>`` end to end, on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mistral-nemo-12b \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-14b \
      --steps 200 --batch 8 --seq 64 --ckpt /tmp/run1

The reference's flags (``repro.launch.train``) plus ``--device``: ``cuda``
by default (attention forward and backward through kernel K5), ``cpu`` for
the plain PyTorch versions. Without ``--full`` the arch's smoke twin
trains; ``--full`` takes the published config on the card (one 80 GB card
holds starcoder2-3b's or minicpm3-4b's float32 masters, moments, bf16 copy
and gradients, ~69 and ~68 GB; ``chip_smoke.py`` trains both, and
mamba2-370m). Every decoder-only config trains: dense (GQA:
mistral-nemo-12b, qwen3-14b, starcoder2-3b; MLA: minicpm3-4b), vision
(pixtral-12b: tokens only, as the reference's launcher feeds it, with the
patch slots masked out of the loss), MoE (phi3.5-moe-42b-a6.6b,
deepseek-v2-lite-16b), SSM (mamba2-370m) and the hybrid
(recurrentgemma-9b, its windowed attention through K5). The
encoder-decoder (whisper-tiny) raises ``ValueError``: its loss needs
frames, which the bigram stream does not hold (the reference's launcher
cannot train it either); ``repro_torch.train.make_train_step`` trains it
on batches with frames. The masters are drawn in float32 from a generator
seeded with ``--seed`` on the device.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.train import (DataConfig, LRSchedule, TrainConfig,
                               bigram_entropy, init_params, train)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="the exact published config (needs the card)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--preempt-after", type=int, default=None,
                    help="fault-tolerance drill: simulate preemption")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    dev = resolve_device(args.device)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    tcfg = TrainConfig(
        steps=args.steps, microbatch=args.microbatch,
        lr=LRSchedule(base=args.lr, warmup=max(10, args.steps // 20),
                      total=args.steps),
        compress_grads=args.compress_grads,
        ckpt_dir=args.ckpt, ckpt_every=max(10, args.steps // 5),
        log_every=max(1, args.steps // 20))
    print(f"[launch] arch={cfg.arch_id} device={dev} "
          f"params~{cfg.n_params()/1e6:.1f}M steps={args.steps} "
          f"CE floor(bigram)={bigram_entropy(dcfg):.3f}")

    def init_fn():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return init_params(cfg, gen, dev)

    _, hist = train(cfg, tcfg, dcfg, init_fn,
                    preempt_after=args.preempt_after, device=dev)
    if hist:
        print(f"[launch] final loss {hist[-1]['loss']:.4f} "
              f"({hist[-1]['step']} steps, {hist[-1]['wall_s']:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
