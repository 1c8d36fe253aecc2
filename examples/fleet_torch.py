"""Fleet exploration on the PyTorch port: several SoC-design scenarios in
one batched run (the twin of ``examples/fleet.py``).

    PYTHONPATH=src python examples/fleet_torch.py               # on the GPU
    PYTHONPATH=src python examples/fleet_torch.py --device cpu  # plain versions

Three scenarios share one candidate pool and one memoized evaluation cache:
two seeds of ResNet-50 (seed-robustness of the learned front) plus a
latency-weighted Transformer scenario (the acquisition spends its
information budget on the latency objective). Each round fits ALL
scenarios' GPs in one Adam loop on one ``BatchedBOEngine``; the evaluations
pending for both workloads go to the SoC model in one kernel launch.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import FleetScenario, fleet_tuner, make_space, pareto_front
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
    pool = space.sample(gen, 500).cpu().numpy()

    # true fronts (cheap surrogate makes this possible) for ADRS reporting
    refs = {w: pareto_front(VLSIFlow(space, w, device=dev)(pool), device=dev)
            for w in ("resnet50", "transformer")}

    scenarios = [
        FleetScenario("resnet50", seed=0),
        FleetScenario("resnet50", seed=1),
        FleetScenario("transformer", seed=0, weights=(3.0, 1.0, 1.0)),
    ]
    fr = fleet_tuner(space, pool, scenarios, T=10, n=16, b=10,
                     reference_fronts=refs, device=dev, verbose=True)

    for sc, res in zip(fr.scenarios, fr.results):
        y = res.pareto_y[np.argsort(res.pareto_y[:, 0])]
        print(f"\n{sc.label}: final ADRS {res.history[-1]['adrs']:.4f}, "
              f"{len(y)} Pareto designs (latency ms, power mW, area mm^2):")
        for row in y[:5]:
            print(f"  {row[0]:8.3f}  {row[1]:8.1f}  {row[2]:7.2f}")

    print(f"\n{fr.cache.summary()}")
    print(f"fleet wall time: {fr.wall_s:.1f}s for {len(scenarios)} scenarios "
          f"on {dev}")


if __name__ == "__main__":
    main()
