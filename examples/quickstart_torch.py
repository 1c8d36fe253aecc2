"""Quickstart on the PyTorch port: explore a small SoC design pool with
SoC-Tuner (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py               # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # plain versions
"""
import argparse

import numpy as np
import torch

from repro_torch.core import make_space, pareto_front, soc_tuner
from repro_torch.device import resolve_device
from repro_torch.soc import VLSIFlow


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.device)  # raises without a card unless cpu

    space = make_space()                       # the paper's TABLE I space
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = space.sample(gen, 500).cpu().numpy()  # candidate designs
    flow = VLSIFlow(space, "resnet50", device=dev)  # latency/power/area

    # reference front (only possible because our flow is cheap; the paper's
    # VLSI flow takes hours per design) — separate flow so the tuner's
    # evaluation budget is counted honestly
    ref = pareto_front(VLSIFlow(space, "resnet50", device=dev)(pool),
                       device=dev)

    result = soc_tuner(space, pool, flow, T=15, n=20, b=12,
                       reference_front=ref, seed=0, device=dev, verbose=True)

    print("\nLearned Pareto-optimal SoC designs (latency ms, power mW, mm^2):")
    for y in result.pareto_y[np.argsort(result.pareto_y[:, 0])][:8]:
        print(f"  {y[0]:8.3f}  {y[1]:8.1f}  {y[2]:7.2f}")
    best = result.pareto_idx(pool)[np.argmin(result.pareto_y[:, 0])]
    vals = space.values(best[None, :])[0]
    print("\nFastest design found:")
    for n_, v in zip(space.names(), vals):
        print(f"  {n_:<10s} {v:g}")
    print(f"\nflow evaluations used: {flow.evaluated} "
          f"(vs {len(pool)} for exhaustive search)")


if __name__ == "__main__":
    main()
