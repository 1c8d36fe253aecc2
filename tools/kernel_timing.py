#!/usr/bin/env python3
"""Device times of K1 ``systolic_eval`` (and its multi-workload entry, in
a tree that has it), K2 ``pairdist``, K3 ``pareto_count``, K4
``round_fused`` (and its chunk refresh and pool scores, in a tree that has
them) and K5 ``flash_attn`` (its bf16 serving forward; in a tree that has
them, its training forward with the row statistic and its backward) at
``chip_smoke.py``'s shapes, for one source tree of the port.

    python3 tools/kernel_timing.py [--tree DIR] [--sweep] [--kernels k5]
                                   [--bwd-splits] [--train]
                                   [--out results.json]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), so a
``git archive`` of another commit unpacked into ``DIR`` is timed with this
script's shapes, inputs and timing (``chip_smoke.time_ms``: calls replayed
from a CUDA graph, warm L2, median of CUDA-event windows). To compare two
trees on one card, run them in turns in one command (A, B, B, A). Prints
the card's name and power limit and one line per shape; ``--out`` also
keeps a sha1 of K1's output at each shape (the multi entry's too), so two
trees' JSON files show whether their K1 agrees bitwise. ``--bwd-splits``
times K5's backward at every split count of its plan. ``--train`` also
times training steps with the tree's port (qwen3-100m's, and starcoder2-3b's
and mamba2-370m's at full width and depth through
``chip_smoke.train_full``, in a tree that trains them), the full-width
ones beside the host's microseconds to issue one tiny eager op. Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def time_k5(cs, dev, out: dict) -> None:
    """K5 (bf16, causal) at ``chip_smoke.K5_SHAPES``, with the inputs of
    ``chip_smoke.check_flash_attn``; in a tree with a backward, the
    training forward and the backward at ``chip_smoke.k5_bwd_cases`` (the
    head dims and masks the tree's backward takes), with the inputs of
    ``chip_smoke.check_flash_attn_backward``, beside the device time of the
    backward of ``scaled_dot_product_attention`` under the same mask
    (``chip_smoke.sdpa_backward``; the port never calls it)."""
    import torch

    from repro_torch.kernels import flash_attn as K5

    out["flash_attn"] = {}
    for B, S, H, K, dqk, dv, window in cs.K5_SHAPES:
        g = torch.Generator(device=dev).manual_seed(B * S + H)
        q, k, v = (torch.randn((B, S, n, d), generator=g, device=dev)
                   .bfloat16() for n, d in ((H, dqk), (K, dqk), (K, dv)))
        with torch.no_grad():
            ms = cs.time_ms(lambda: K5.flash_attention(q, k, v, window=window),
                            reps=5, repeats=7)[0]
        key = f"{B}x{S}x{H}/{K}x{dqk}/{dv}" + (f" window {window}"
                                                if window else "")
        out["flash_attn"][key] = ms
        print(f"  flash_attn [{key}]: {ms:.4f} ms")
    if not hasattr(K5, "flash_attention_backward"):
        return
    out["flash_attn_train"], out["flash_attn_bwd"] = {}, {}
    masks = hasattr(K5, "bwd_class_launches")  # an older tree: causal only
    for B, S, H, K, dqk, dv, used, W, causal, _ in cs.k5_bwd_cases():
        masked = bool(W) or not causal
        if (dqk, dv) not in K5.BWD_HEAD_DIMS or (masked and not masks):
            continue  # a case an older tree's backward lacks
        q, k, v, dout, scale = cs.k5_bwd_inputs(dev, B, S, H, K, dqk, dv,
                                                used)
        mask = (W, causal) if masked else ()
        out_k, lse, *lo = K5.flash_attention_lse(q, k, v, scale, *mask)
        kw = dict(out_lo=lo[0]) if lo else {}  # an older tree has no out_lo
        key = f"{B}x{S}x{H}/{K}x{dqk}" + ("" if dv == dqk else f"/{dv}") + (
            " no causal mask" if not causal else f" window {W}" if W else "")
        fwd = cs.time_ms(lambda: K5.flash_attention_lse(q, k, v, scale,
                                                        *mask),
                         reps=5, repeats=7)[0]
        bwd = cs.time_ms(lambda: K5.flash_attention_backward(
            q, k, v, out_k, lse, dout, scale, *mask, **kw), reps=5,
            repeats=7)[0]
        lib = cs.sdpa_backward(q, k, v, dout, scale,
                               cs.sdpa_mask(S, W, causal, dev)[0])[0][0]
        out["flash_attn_train"][key], out["flash_attn_bwd"][key] = fwd, bwd
        out.setdefault("sdpa_bwd", {})[key] = lib
        print(f"  flash_attn [{key}] with lse: {fwd:.4f} ms; backward "
              f"{bwd:.4f} ms; sdpa's backward {lib:.4f} ms")
        del q, k, v, dout, out_k, lse, lo
        torch.cuda.empty_cache()


def host_op_us(n: int = 20000) -> float:
    """Microseconds the host takes to issue one tiny eager CUDA op (an add
    on a 1-element tensor), over ``n`` calls: the rate that bounds a
    training step of tens of thousands of launches."""
    import time

    import torch

    a = torch.zeros(1, device="cuda")
    for _ in range(100):
        a.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        a.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def time_train(cs, dev, out: dict) -> None:
    """Seconds a training step: qwen3-100m (``chip_smoke.qwen3_100m``, B 16
    x S 128) over TRAIN_QWEN_STEPS steps after TRAIN_QWEN_WARM, median; then
    ``chip_smoke.train_full`` (starcoder2-3b at full width and depth, B 2 x
    S 2048, remat: its timed steps, the step's parts and device time by
    kernel group under the profiler), and mamba2-370m's
    (``chip_smoke.TRAIN_FULL_SSM``) in a tree that trains the SSM family;
    each beside :func:`host_op_us`, taken just before."""
    import statistics
    import time

    import torch

    from repro_torch.kernels import flash_attn as K5
    from repro_torch.train import (DataConfig, TrainConfig, init_params,
                                   make_batch, make_train_step)
    from repro_torch.train.optimizer import adamw_init

    if not hasattr(K5, "bwd_class_launches"):  # an older tree: no masks
        K5.bwd_class_launches = {}

    cfg = cs.qwen3_100m()
    dcfg = DataConfig(vocab=cfg.vocab, **cs.TRAIN_DATA)
    state = adamw_init({k: v.to(dev) for k, v in init_params(
        cfg, torch.Generator().manual_seed(0), "cpu").items()})
    step = make_train_step(cfg, TrainConfig(), dev)
    times = []
    for i in range(TRAIN_QWEN_WARM + TRAIN_QWEN_STEPS):
        batch = make_batch(dcfg, i, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, _ = step(state, batch, None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    qwen = statistics.median(times[TRAIN_QWEN_WARM:])
    print(f"  train {cfg.arch_id}: {1e3 * qwen:.2f} ms a step (median of "
          f"{TRAIN_QWEN_STEPS})")
    del state, step
    torch.cuda.empty_cache()
    keys = ("step_median_s", "step_s", "fwd_bwd_s", "adamw_s", "copy_s",
            "device_busy_s", "device_busy_share", "device_launches",
            "by_group", "peak_gb")
    out["train"] = dict(qwen3_100m_step_s=qwen)
    for name, conf in (("starcoder2_3b", cs.TRAIN_FULL),
                       ("mamba2_370m", cs.TRAIN_FULL_SSM)):
        host = host_op_us()
        print(f"  host: {host:.2f} us to issue a tiny eager op")
        try:
            full = cs.train_full(dev, conf)
        except NotImplementedError as e:  # an older tree: not trainable
            print(f"  {conf['arch']}: {e}")
            continue
        out["train"][name] = dict({k: full.get(k) for k in keys},
                                  host_op_us=host)


def time_bwd_splits(cs, dev, out: dict) -> None:
    """K5's backward at ``BWD_SPLIT_SHAPES`` with its plan's splits forced
    to each divisor of H/K (``flash_attn.bwd_plan(..., splits=)``), beside the
    plan's own choice: the measurement behind ``BWD_MIN_BLOCKS`` and
    ``BWD_MAX_SPLITS``."""
    import torch

    from repro_torch.kernels import flash_attn as K5

    plan = K5.bwd_plan
    out["bwd_splits"] = {}
    try:
        for B, S, H, K, hd in BWD_SPLIT_SHAPES:
            g = torch.Generator(device=dev).manual_seed(B * S + H + 7)
            q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev)
                       .bfloat16() for n in (H, K, K))
            dout = torch.randn((B, S, H, hd), generator=g,
                               device=dev).bfloat16()
            o, lse, *lo = K5.flash_attention_lse(q, k, v)
            kw = dict(out_lo=lo[0]) if lo else {}  # an older tree: none
            key = f"{B}x{S}x{H}/{K}x{hd}"
            times = {}
            for d in (d for d in range(1, H // K + 1) if (H // K) % d == 0):
                K5.bwd_plan = functools.partial(plan, splits=d)
                times[d] = cs.time_ms(lambda: K5.flash_attention_backward(
                    q, k, v, o, lse, dout, **kw), reps=5, repeats=7)[0]
            K5.bwd_plan = plan
            out["bwd_splits"][key] = times
            print(f"  flash_attn backward [{key}] by splits (the plan takes "
                  f"{plan(B, S, H, K, hd, hd)['splits']}): " + ", ".join(
                      f"{d}: {ms:.4f} ms" for d, ms in times.items()))
    finally:
        K5.bwd_plan = plan


#: tools/kernel_timing.py --bwd-splits: starcoder2-3b's shape and a group of
#: 16 query heads on one KV head at a short S
BWD_SPLIT_SHAPES = [(2, 2048, 24, 2, 128), (2, 300, 16, 1, 128)]
#: tools/kernel_timing.py --train: qwen3-100m's warm-up and timed steps
TRAIN_QWEN_WARM, TRAIN_QWEN_STEPS = 5, 20


def time_k1_k4(cs, args, dev, out: dict) -> None:
    """K1-K4 at chip_smoke's shapes (``--sweep``: also at other plans)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import pairdist as K2
    from repro_torch.kernels import pareto_count as K3
    from repro_torch.kernels import round_fused as K4
    from repro_torch.kernels import systolic_eval as K1

    out.update(systolic_eval={}, systolic_eval_sha1={}, pairdist={},
               pareto_count={}, round_fused={})
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT),
                    help="root of the source tree whose kernels are timed")
    ap.add_argument("--out", help="also write the times as JSON here")
    ap.add_argument("--sweep", action="store_true",
                    help="also time K1 at every group width, K2 at every "
                         "tile height tm and K3 at other plans and shapes (a "
                         "tree whose kernels have launch plans)")
    ap.add_argument("--kernels", choices=("all", "k5"), default="all",
                    help="k5: time K5 alone")
    ap.add_argument("--bwd-splits", action="store_true",
                    help="also time K5's backward at every split count of "
                         "its plan (a tree whose backward has bwd_plan)")
    ap.add_argument("--train", action="store_true",
                    help="also time training steps: qwen3-100m, and "
                         "starcoder2-3b and mamba2-370m at full width and "
                         "depth")
    args = ap.parse_args()

    import chip_smoke as cs  # puts this checkout's src first on sys.path

    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card} | tree {args.tree} | repro_torch from "
          f"{Path(repro_torch.__file__).parent}")
    out = dict(card=card, tree=args.tree)
    if args.kernels == "all":
        time_k1_k4(cs, args, dev, out)
    time_k5(cs, dev, out)
    if args.bwd_splits:
        time_bwd_splits(cs, dev, out)
    if args.train:
        time_train(cs, dev, out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
