"""Serving launcher: batched prefill, then greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \
      --full --batch 4 --prompt-len 2048 --gen 32 --max-len 2080
  PYTHONPATH=src python -m repro_torch.launch.serve --arch minicpm3-4b \
      --full --batch 4 --prompt-len 2048 --gen 32 --max-len 2080

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --full --batch 4 --prompt-len 2048 \
      --gen 32 --max-len 2080
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch recurrentgemma-9b --full --batch 4 --prompt-len 4096 \
      --gen 32 --max-len 4128
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --full --batch 4 --prompt-len 416 --gen 32 --max-len 448
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \
      --full --batch 4 --prompt-len 2048 --gen 32 --max-len 2080

The dense family runs: GQA (mistral-nemo-12b, qwen3-14b, starcoder2-3b)
and MLA (minicpm3-4b); so does the MoE family: phi3.5-moe-42b-a6.6b (GQA,
16 experts, top-2) and deepseek-v2-lite-16b (MLA, 64 routed experts,
top-6, 2 shared, a dense layer 0). phi3.5-moe at its full 32 layers (41.9 B
parameters, 83.7 GB in bf16) does not fit one 80 GB card; its smoke twin
and a depth cut (``chip_smoke.py`` serves 24 layers) do. So do the SSM
family (mamba2-370m) and the hybrid one (recurrentgemma-9b: RG-LRU layers
and attention over a 2048-token window; ``--max-len`` at or past the
window makes the cache a ring that a longer prompt and decode wrap), the
encoder-decoder (whisper-tiny: random frame embeddings [batch, enc_len,
d_model] stand for its conv frontend's output, as the reference's
launcher draws them) and the vision frontend (pixtral-12b: random patch
embeddings [batch, n_patches, d_model] stand for its ViT's, in the
prompt's first slots).

Without ``--full`` the arch's smoke twin runs. The weights are drawn from a
generator seeded with ``--seed`` straight into bf16 on the device, one
tensor at a time. ``--device`` defaults to ``cuda``; ``--device cpu`` runs
the plain PyTorch versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init
from repro_torch.serve import Engine, ServeConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = init(cfg, gen, dev)
    eng = Engine(cfg, model, ServeConfig(max_len=args.max_len))
    tokens = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    inputs = {}
    if cfg.frontend == "audio":
        inputs["frames"] = torch.randn((args.batch, cfg.enc_len, cfg.d_model),
                                       generator=gen, device=dev)
    if cfg.frontend == "vision":
        inputs["images"] = torch.randn(
            (args.batch, cfg.n_patches, cfg.d_model), generator=gen,
            device=dev)
    t0 = time.perf_counter()
    out = eng.generate(tokens, steps=args.gen, **inputs)
    out = out.cpu()  # waits for the device
    dt = time.perf_counter() - t0
    print(f"[serve] arch={cfg.arch_id} device={dev} generated "
          f"{tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s)")
    print(out[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
