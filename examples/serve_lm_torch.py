"""Batched serving example on PyTorch: prefill a batch of prompts, decode
greedily. The twin of ``examples/serve_lm.py``.

Runs every family that has a decode path (dense GQA, MLA, MoE, SSM, hybrid,
enc-dec) at smoke scale to show the one Engine API covering all of them:
on the card by default (prefill attention through kernel K5), or with
``--device cpu`` on the plain PyTorch versions.

    PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init
from repro_torch.serve import Engine, ServeConfig

ARCHS = ["mistral-nemo-12b", "deepseek-v2-lite-16b", "mamba2-370m",
         "recurrentgemma-9b", "whisper-tiny"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        gen = torch.Generator(device=dev).manual_seed(0)
        model = init(cfg, gen, dev)
        eng = Engine(cfg, model, ServeConfig(max_len=64))
        tokens = torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                               device=dev)
        inputs = {}
        if cfg.frontend == "audio":
            inputs["frames"] = torch.randn((4, cfg.enc_len, cfg.d_model),
                                           generator=gen, device=dev)
        if cfg.frontend == "vision":
            inputs["images"] = torch.randn((4, cfg.n_patches, cfg.d_model),
                                           generator=gen, device=dev)
        t0 = time.perf_counter()
        out = eng.generate(tokens, steps=12, **inputs).cpu()
        dt = time.perf_counter() - t0
        print(f"{arch:<24s} family={cfg.family:<7s} "
              f"generated {tuple(out.shape)} in {dt:5.1f}s | "
              f"sample: {list(map(int, out[0][:8]))}")


if __name__ == "__main__":
    main()
