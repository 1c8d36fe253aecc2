#!/usr/bin/env python3
"""Device times of K1 ``systolic_eval`` (and its multi-workload entry, in
a tree that has it), K2 ``pairdist``, K3 ``pareto_count`` and K4
``round_fused`` (and its chunk refresh and pool scores, in a tree that has
them) at ``chip_smoke.py``'s shapes, for one source tree of the port.

    python3 tools/kernel_timing.py [--tree DIR] [--sweep] [--out results.json]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so a
``git archive`` of another commit unpacked into ``DIR`` is timed with this
script's shapes, inputs and timing (``chip_smoke.time_ms``: calls replayed
from a CUDA graph, warm L2, median of CUDA-event windows). To compare two
trees on one card, run them in turns in one command (A, B, B, A). Prints
the card's name and power limit and one line per shape; ``--out`` also
keeps a sha1 of K1's output at each shape (the multi entry's too), so two
trees' JSON files show whether their K1 agrees bitwise. Needs a CUDA
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
                    help="also time K1 at every group width, K2 at every "
                         "tile height tm and K3 at other plans and shapes (a "
                         "tree whose kernels have launch plans)")
    args = ap.parse_args()

    import chip_smoke as cs  # puts this checkout's src first on sys.path

    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels import pairdist as K2
    from repro_torch.kernels import pareto_count as K3
    from repro_torch.kernels import round_fused as K4
    from repro_torch.kernels import systolic_eval as K1

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card} | tree {args.tree} | repro_torch from "
          f"{Path(repro_torch.__file__).parent}")
    out = dict(card=card, tree=args.tree, systolic_eval={},
               systolic_eval_sha1={}, pairdist={}, pareto_count={},
               round_fused={})

    pool = cs.k1_pool(dev)
    for workload, n in cs.K1_SHAPES:
        vals, layers = cs.k1_inputs(dev, pool, workload, n)
        key = f"{workload} {n}x26x{layers.shape[0]}"
        y = K1.soc_metrics(vals, layers)
        out["systolic_eval_sha1"][key] = cs.tensor_sha1(y)
        ms = cs.time_ms(lambda: K1.soc_metrics(vals, layers))[0]
        out["systolic_eval"][key] = ms
        line = (f"  systolic_eval [{n}, 26, {layers.shape[0]}] ({workload}): "
                f"{ms:.4f} ms, output sha1 {out['systolic_eval_sha1'][key]}")
        if args.sweep and hasattr(K1, "launch_plan"):
            o = torch.empty((n, 3), device=dev)
            L = layers.shape[0]

            def launch(p):
                build.check(build.library().systolic_eval_launch(
                    vals.data_ptr(), layers.data_ptr(), o.data_ptr(), n, L,
                    p["g_log2"], p["kr"], p["threads"], p["stride"],
                    p["smem_bytes"], build.stream_ptr(vals)), "systolic_eval")

            by_g = {}
            for g in (32, 16, 8, 4):
                try:
                    p = K1.launch_plan(n, L, g)
                except ValueError:  # a warp of designs does not fit
                    continue
                by_g[g] = cs.time_ms(lambda: launch(p))[0]
            out["systolic_eval"][f"{key} by lanes"] = by_g
            line += (f" (plan {K1.launch_plan(n, L)['g']} lanes a design; "
                     + ", ".join(f"{g}: {v:.4f}" for g, v in by_g.items())
                     + ")")
        print(line)
        if (workload, n) == ("resnet50", 2500):
            y_pool = K1.soc_metrics_plain(vals, layers)

    # K1's multi-workload entry (the fleet's fused flush): a round's picks
    # (3 x 2) and 3 x 2500, with one single launch a workload beside it
    if hasattr(K1, "soc_metrics_multi"):
        out["systolic_eval_multi"] = {}
        for n in (2, 2500):
            vals, layers, mask = cs.k1_multi_inputs(dev, n)
            key = f"{vals.shape[0]}x{n}x26x{layers.shape[1]}"
            y = K1.soc_metrics_multi(vals, layers, mask)
            out["systolic_eval_sha1"][f"multi {key}"] = cs.tensor_sha1(y)
            ms = cs.time_ms(lambda: K1.soc_metrics_multi(vals, layers, mask))[0]
            singles = [(vals[w].contiguous(), layers[w, :int(mask[w].sum())]
                        .contiguous()) for w in range(vals.shape[0])]
            ms_s = cs.time_ms(lambda: [K1.soc_metrics(v, l)
                                       for v, l in singles])[0]
            out["systolic_eval_multi"][key] = dict(ms=ms, singles_ms=ms_s)
            print(f"  systolic_eval_multi [{key}]: {ms:.4f} ms (one single "
                  f"launch a workload: {ms_s:.4f} ms), output sha1 "
                  f"{out['systolic_eval_sha1'][f'multi {key}']}")

    for n in cs.K3_SHAPES + cs.K3_ROUND_FRONTS:
        yd = cs.k3_inputs(y_pool, n)
        ms = cs.time_ms(lambda: K3.dominance_counts(yd))[0]
        out["pareto_count"][f"{n}x3"] = ms
        line = f"  pareto_count [{n}, 3]: {ms:.4f} ms"
        if args.sweep and hasattr(K3, "launch_plan"):
            c = torch.empty((n,), dtype=torch.int32, device=dev)

            def launch(p):
                build.check(build.library().pareto_count_launch(
                    yd.data_ptr(), c.data_ptr(), n, 3, p["rows_per_thread"],
                    p["rows_per_block"], p["s_log2"], p["threads"],
                    p["tile_rows"], p["smem_bytes"], build.stream_ptr(yd)),
                    "pareto_count")

            if n > K3.FRONT_ROWS:  # blocks an SM, splits a row thread
                plans = {f"{k} an SM, {s} splits":
                         K3.launch_plan(n, 3, k, s)
                         for k in (1, 2) for s in (32, 64, 128)}
            else:  # rows a block, splits a row thread
                plans = {f"{b} rows a block, {s} splits":
                         K3.launch_plan(n, 3, splits=s, block_rows=b)
                         for b in (8, 16, 32, n) for s in (8, 16, 32)}
            by_plan = {key: cs.time_ms(lambda: launch(p))[0]
                       for key, p in plans.items()}
            out["pareto_count"][f"{n}x3 by plan"] = by_plan
            line += (" (" + ", ".join(f"{key}: {v:.4f}"
                                      for key, v in by_plan.items()) + ")")
        print(line)

    gen = torch.Generator(device=dev).manual_seed(1234)
    x_all = torch.rand((2500, 26), generator=gen, device=dev)
    for n, m in cs.K2_SHAPES:
        x, y = x_all[:n].contiguous(), x_all.flip(0)[:m].contiguous()
        ms = cs.time_ms(lambda: K2.pairdist(x, y))[0]
        out["pairdist"][f"{n}x{m}x26"] = ms
        line = f"  pairdist [{n}, {m}, 26] d²: {ms:.4f} ms"
        if args.sweep:
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
    # K4's pool uses (a tree that has them): the chunk refresh and the
    # pool scores at chip_smoke.py's shapes
    if hasattr(K4, "refresh_chunks"):
        for nc, C, P, dirty in cs.K4_REFRESH_SHAPES:
            t = cs.k4_problem(dev, nc, C, 26, P, 3, 10,
                              seed=nc * C + len(dirty))
            didx = torch.as_tensor(dirty, device=dev)
            t.update(V=t["V"][didx], pool_c=t["pool_c"][didx],
                     evalm_c=t["evalm_c"][didx])
            kargs = [t[k] for k in cs.K4_ARGS]
            ms = cs.time_ms(lambda: K4.refresh_chunks(*kargs, nc_full=nc))[0]
            key = f"refresh {len(dirty)} of {nc}x{C}x26x3x{P}x10"
            out["round_fused"][key] = ms
            print(f"  round_fused refresh [{len(dirty)} of {nc}, {C}, 26, 3, "
                  f"{P}, 10, 0]: {ms:.4f} ms")
        for nc, C, P in cs.K4_SCORES_SHAPES:
            t = cs.k4_problem(dev, nc, C, 26, P, 3, 10, seed=nc * C + P + 1)
            kargs = [t[k] for k in cs.K4_ARGS]
            sc = torch.empty((nc, C), device=dev)
            large = nc * C >= cs.K4_LARGE
            ms = cs.time_ms(lambda: K4.round_select(*kargs, s0=P, scores=sc),
                            reps=5 if large else 20,
                            repeats=5 if large else 7)[0]
            out["round_fused"][f"scores {nc}x{C}x26x3x{P}x10"] = ms
            print(f"  round_fused scores [{nc}, {C}, 26, 3, {P}, 10, {P}]: "
                  f"{ms:.4f} ms")
            del t, kargs
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
