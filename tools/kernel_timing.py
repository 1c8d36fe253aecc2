#!/usr/bin/env python3
"""Device times of K2 ``pairdist`` and K4 ``round_fused`` at
``chip_smoke.py``'s shapes, for one source tree of the port.

    python3 tools/kernel_timing.py [--tree DIR] [--sweep] [--out results.json]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so a
``git archive`` of another commit unpacked into ``DIR`` is timed with this
script's shapes, inputs and timing (``chip_smoke.time_ms``: calls replayed
from a CUDA graph, warm L2, median of CUDA-event windows). To compare two
trees on one card, run them in turns in one command (A, B, B, A). Prints
the card's name and power limit and one line per shape. Needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the source tree whose kernels are timed")
    ap.add_argument("--out", help="also write the times as JSON here")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K2 at every tile height tm (a tree "
                         "whose pairdist has a launch plan)")
    args = ap.parse_args()

    import chip_smoke as cs  # puts this checkout's src first on sys.path

    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import pairdist as K2
    from repro_torch.kernels import round_fused as K4

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card} | tree {args.tree} | repro_torch from "
          f"{Path(repro_torch.__file__).parent}")
    out = dict(card=card, tree=args.tree, pairdist={}, round_fused={})

    gen = torch.Generator(device=dev).manual_seed(1234)
    x_all = torch.rand((2500, 26), generator=gen, device=dev)
    for n, m in cs.K2_SHAPES:
        x, y = x_all[:n].contiguous(), x_all.flip(0)[:m].contiguous()
        ms = cs.time_ms(lambda: K2.pairdist(x, y))[0]
        out["pairdist"][f"{n}x{m}x26"] = ms
        line = f"  pairdist [{n}, {m}, 26] d²: {ms:.4f} ms"
        if args.sweep:
            from repro_torch.kernels import build

            o = torch.empty((n, m), device=dev)
            by_tm = {tm: cs.time_ms(lambda: build.check(
                build.library().pairdist_launch(
                    x.data_ptr(), y.data_ptr(), o.data_ptr(), n, m, 26, 0,
                    0.0, tm, build.stream_ptr(x)), "pairdist"))[0]
                for tm in (8, 4, 2, 1)}
            out["pairdist"][f"{n}x{m}x26 by tm"] = by_tm
            line += (f" (plan tm {K2.launch_plan(n, m, 26)['tm']}; "
                     + ", ".join(f"tm {tm}: {v:.4f}" for tm, v in
                                 by_tm.items()) + ")")
        print(line)

    for nc, C, P, s0 in cs.K4_SHAPES:
        t = cs.k4_problem(dev, nc, C, 26, P, 3, 10, seed=nc * C + P + s0)
        kargs = [t[k] for k in cs.K4_ARGS]
        large = nc * C >= cs.K4_LARGE
        ms = cs.time_ms(lambda: K4.round_select(*kargs, s0=s0),
                        reps=5 if large else 20,
                        repeats=5 if large else 7)[0]
        out["round_fused"][f"{nc}x{C}x26x3x{P}x10 s0={s0}"] = ms
        print(f"  round_fused [{nc}, {C}, 26, 3, {P}, 10, {s0}]: {ms:.4f} ms")
        del t, kargs
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
