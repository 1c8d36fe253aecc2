"""Full SoC exploration for a target DNN on the PyTorch port — the paper's
end-to-end use case (the twin of ``examples/soc_exploration.py``).

Explores the TABLE I space for a chosen workload (the paper's benchmarks or
an LM architecture lowered to a systolic workload), compares SoC-Tuner
against a baseline, and prints the balanced optimum.

    PYTHONPATH=src python examples/soc_exploration_torch.py --workload resnet50
    PYTHONPATH=src python examples/soc_exploration_torch.py --device cpu \
        --pool 300 --T 6 --baseline svr
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (BASELINES, make_space, pareto_front,
                              run_baseline, soc_tuner)
from repro_torch.device import resolve_device
from repro_torch.random import GeneratorDraws
from repro_torch.soc import VLSIFlow


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="transformer",
                    help="resnet50 | mobilenet | transformer | <arch>[:mode]")
    ap.add_argument("--pool", type=int, default=1500)
    ap.add_argument("--T", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default="random", choices=BASELINES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)  # raises without a card unless cpu

    space = make_space()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    pool = space.sample(gen, args.pool).cpu().numpy()
    ref = pareto_front(VLSIFlow(space, args.workload, device=dev)(pool),
                       device=dev)

    print(f"== SoC-Tuner on {args.workload} ==")
    ours = soc_tuner(space, pool, VLSIFlow(space, args.workload, device=dev),
                     T=args.T, reference_front=ref, seed=args.seed,
                     device=dev, verbose=True)
    print(f"== {args.baseline} baseline ==")
    base = run_baseline(args.baseline, space, pool,
                        VLSIFlow(space, args.workload, device=dev), T=args.T,
                        reference_front=ref,
                        draws=GeneratorDraws(args.seed, dev), device=dev)
    print(f"\nADRS   soc-tuner={ours.history[-1]['adrs']:.4f}   "
          f"{args.baseline}={base.history[-1]['adrs']:.4f}")

    front = ours.pareto_y
    z = (front - front.min(0)) / np.maximum(np.ptp(front, 0), 1e-12)
    pick = int(np.argmin(np.linalg.norm(z, axis=1)))
    idx = ours.pareto_idx(pool)[pick]
    print(f"\nBalanced optimum for {args.workload} "
          f"(lat={front[pick, 0]:.3f}ms, p={front[pick, 1]:.0f}mW, "
          f"a={front[pick, 2]:.2f}mm2):")
    for name, val in zip(space.names(), space.values(idx[None, :])[0]):
        print(f"  {name:<10s} {val:g}")


if __name__ == "__main__":
    main()
