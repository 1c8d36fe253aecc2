"""Mesh-Tuner on the PyTorch port: SoC-Tuner's IMOO loop pointed at the
sharded LM program's own configuration (the twin of
``examples/mesh_tuner.py``).

A design point is a (microbatch, remat, embed_fsdp axes, ZeRO-1)
configuration, the "flow" is one dry run of the cell over a fake process
group of 256 (or 512) ranks (``repro_torch.launch.dryrun``, a subprocess of
its own: tens of seconds to minutes), and the metrics are the three
roofline terms of its per-device counts on an H100 SXM
(``repro_torch.launch.roofline``). The port's ``fit_gp``, ``imoo_scores``
and ``pareto_mask`` drive the search, unchanged.

    PYTHONPATH=src python examples/mesh_tuner_torch.py --arch qwen3-14b \\
        --shape train_4k --T 2 --b 2

The evaluations are host programs (fake tensors, no device), so the GP
runs on the host too unless ``--device cuda`` asks for the card.
"""
import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core import fit_gp, imoo_scores, pareto_mask
from repro_torch.device import resolve_device
from repro_torch.launch.roofline import terms

# ---------------------------------------------------------- design space
KNOBS = {
    "microbatch": [1, 2, 4, 8],
    "remat": [True, False],
    "fsdp": ["both", "data", "off"],     # embed_fsdp candidate axes
    "zero1": [True, False],              # opt-state data sharding
}


def knob_grid():
    keys = list(KNOBS)
    for combo in itertools.product(*(KNOBS[k] for k in keys)):
        yield dict(zip(keys, combo))


def encode(pt: dict) -> list[float]:
    return [np.log2(pt["microbatch"]) / 3.0, float(pt["remat"]),
            {"both": 1.0, "data": 0.5, "off": 0.0}[pt["fsdp"]],
            float(pt["zero1"])]


def to_overrides(pt: dict) -> dict:
    rules = {}
    if pt["fsdp"] == "off":
        rules["embed_fsdp"] = []
    elif pt["fsdp"] == "data":
        rules["embed_fsdp"] = [["data"]]
    ov = {"microbatch": pt["microbatch"], "remat": pt["remat"]}
    if rules:
        ov["rules"] = rules
    if not pt["zero1"]:
        ov["zero1"] = False
    return ov


# ------------------------------------------------------------ evaluation
def evaluate(arch: str, shape: str, mesh: str, pt: dict, out_dir: str) -> dict:
    """One dry run in a subprocess (it needs a process group of its own)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out_dir,
           "--overrides", json.dumps(to_overrides(pt))]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, PYTHONPATH=src)
    res = subprocess.run(cmd, capture_output=True, text=True, env=env)
    line = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else "{}"
    rec = json.loads(line)
    if rec.get("status") != "ok":
        raise RuntimeError(rec.get("error", "dry run failed"))
    t = terms(rec)
    return {"compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "collective_s": t["collective_s"],
            "step_s": max(t["compute_s"], t["memory_s"], t["collective_s"]),
            "mem_bytes": rec.get("temp_size_in_bytes", 0),
            "roofline_frac": t["roofline_frac"]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--T", type=int, default=5, help="BO rounds")
    ap.add_argument("--b", type=int, default=3, help="init points")
    ap.add_argument("--device", default="cpu",
                    help="the GP's device: cpu (default) or cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    pool = list(knob_grid())
    X = torch.tensor([encode(p) for p in pool], dtype=torch.float32,
                     device=dev)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    evaluated: dict[int, dict] = {}
    tmp = tempfile.mkdtemp(prefix="meshtuner_")

    def run_row(i: int):
        pt = pool[i]
        try:
            m = evaluate(args.arch, args.shape, args.mesh, pt, tmp)
        except RuntimeError as e:
            m = {"step_s": 1e6, "collective_s": 1e6, "mem_bytes": 1e15,
                 "roofline_frac": 0.0}
            print(f"  x {pt} -> dry run FAILED ({e})")
            return m
        print(f"  . {pt} -> step={m['step_s']:.2f}s "
              f"coll={m['collective_s']:.2f}s "
              f"roofline={m['roofline_frac']*100:.1f}%", flush=True)
        return m

    def objectives(rows):
        return np.asarray([[evaluated[r]["step_s"],
                            evaluated[r]["collective_s"],
                            evaluated[r]["mem_bytes"] / 1e9] for r in rows])

    print(f"== Mesh-Tuner (port): {args.arch} / {args.shape} on {args.mesh} "
          f"mesh ({len(pool)} candidate configs) ==", flush=True)
    for i in rng.choice(len(pool), size=args.b, replace=False):
        evaluated[int(i)] = run_row(int(i))

    for _ in range(args.T):
        rows = sorted(evaluated)
        # objectives: minimize (step_s, collective_s, mem_bytes)
        Y = objectives(rows)
        state = fit_gp(X[torch.tensor(rows, device=dev)],
                       torch.tensor(-Y, dtype=torch.float32, device=dev),
                       steps=80)
        eps = torch.randn((Y.shape[1], len(pool), 8), generator=gen,
                          device=dev)
        scores = imoo_scores(state, X, eps).cpu().numpy()
        scores[np.asarray(rows)] = -np.inf
        nxt = int(np.argmax(scores))
        evaluated[nxt] = run_row(nxt)

    rows = sorted(evaluated)
    Y = objectives(rows)
    mask = pareto_mask(torch.tensor(Y, dtype=torch.float32,
                                    device=dev)).cpu().numpy()
    print("\nPareto-optimal configurations:")
    for r, keep in zip(rows, mask):
        if keep:
            print(f"  {pool[r]} -> step={Y[rows.index(r), 0]:.2f}s "
                  f"mem={Y[rows.index(r), 2]:.1f}GB "
                  f"roofline={evaluated[r]['roofline_frac']*100:.1f}%")
    best = max(evaluated, key=lambda r: evaluated[r]["roofline_frac"])
    print(f"\nBest roofline fraction: {pool[best]} "
          f"({evaluated[best]['roofline_frac']*100:.1f}%)")


if __name__ == "__main__":
    main()
