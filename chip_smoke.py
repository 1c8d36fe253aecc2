#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Builds the port's CUDA kernels (``src/repro_torch/csrc``) with ``nvcc``,
holds each kernel against its plain PyTorch version on the card at the main
path's shapes and times both, then drives the main path — a paper-protocol
``soc_tuner`` run (n_pool=2500, resnet50, T=20, n=30, b=20, gp_steps=150,
10 frontier samples over a 512-row subset) with its reference front — and
checks that every kernel was launched in it and that its results are right.
It prints the card (``nvidia-smi``), the build time, one line per kernel
check, the rounds, a ``{"kernels": [...]}`` JSON line and, last,
``{"ok": true, "device": {...}}``. Any failure raises; no phase is caught.
It needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
#: (non-tensor-core) operations/s. Roofline bounds are stated against these.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
#: float32 operations per (design, layer) pair of the SoC model, counted by
#: hand in repro_torch/soc/model.py (~101 in _layer_cost, ~28 in the
#: per-layer epilogue and sums); the per-design epilogue is negligible.
K1_OPS_PER_PAIR = 129
#: operations per (i, j) pair of dominance counting with m objectives:
#: m `<=` and m `<` compares, m + 1 logic ops, one add.
K3_OPS_PER_PAIR = lambda m: 3 * m + 2  # noqa: E731

MAIN = dict(n_pool=2500, workload="resnet50", T=20, n=30, b=20, gp_steps=150,
            s_frontiers=10, frontier_subset=512, seed=0)
SMALL = dict(n_pool=64, workload="resnet50", T=6, n=10, b=8, gp_steps=25,
             s_frontiers=10, frontier_subset=512, seed=3)


def _event_ms(fn, repeats: int) -> float:
    """Median milliseconds of ``fn()`` over ``repeats`` CUDA-event windows."""
    import torch

    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def time_ms(fn, reps: int = 20, repeats: int = 7) -> tuple[float, float]:
    """Per-call milliseconds of ``fn`` by CUDA events, median of ``repeats``
    windows of ``reps`` calls (warm L2): ``(device, eager)``. ``device``
    replays the calls from a CUDA graph, so the card runs them back to back
    and the time is the device's; ``eager`` issues them from Python, so it
    includes whatever the host adds between launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    device = _event_ms(graph.replay, repeats) / reps
    eager = _event_ms(lambda: [fn() for _ in range(reps)], repeats) / reps
    return device, eager


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.core.space import make_space
    from repro_torch.kernels import pairdist as K2
    from repro_torch.kernels import pareto_count as K3
    from repro_torch.kernels import systolic_eval as K1
    from repro_torch.soc.workloads import get_workload

    space = make_space()
    gen = torch.Generator(device=dev).manual_seed(1234)
    pool = space.sample(gen, 2500).cpu().numpy()
    layers = torch.as_tensor(get_workload("resnet50"), dtype=torch.float32,
                             device=dev)
    results = {}

    def record(name, shape, err, tol_ok, t_k, t_p, t_lib, bound):
        """``t_*`` are (device, eager) pairs from :func:`time_ms`."""
        lib = "n/a" if t_lib is None else f"{t_lib[0]:.4f}/{t_lib[1]:.4f} ms"
        print(f"  {name} {shape}: max_abs_err={err:.3e} ok={tol_ok} "
              f"device/eager: kernel={t_k[0]:.4f}/{t_k[1]:.4f} ms "
              f"plain={t_p[0]:.4f}/{t_p[1]:.4f} ms library={lib} "
              f"bound={bound[0]:.5f} ms ({bound[1]})")
        if not tol_ok:
            raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                                 f"plain version (max abs err {err:.3e})")
        results.setdefault(name, []).append(dict(
            shape=shape, max_abs_err=err, ms=t_k[0], plain_ms=t_p[0],
            library_ms=None if t_lib is None else t_lib[0],
            eager_ms=t_k[1], plain_eager_ms=t_p[1],
            library_eager_ms=None if t_lib is None else t_lib[1],
            bound_ms=bound[0], bound_by=bound[1]))

    # --- K1 systolic_eval: the reference-front sweep (N=2500) and one
    # design (a BO round's evaluation) on resnet50's 54 layers.
    for n in (2500, 1):
        vals = torch.as_tensor(space.values(pool[:n]), dtype=torch.float32,
                               device=dev).contiguous()
        out_k = K1.soc_metrics(vals, layers)
        out_p = K1.soc_metrics_plain(vals, layers)
        torch.cuda.synchronize()
        # float32 sums over L=54 layers in another order (<= L*2^-24 ~ 3.2e-6
        # relative) plus powf/log2f ulps: rtol 2e-5
        ok = bool(torch.allclose(out_k, out_p, rtol=2e-5, atol=0.0))
        err = float((out_k - out_p).abs().max())
        L = layers.shape[0]
        bnd = bound_ms(4 * (n * 26 + L * 5 + n * 3), n * L * K1_OPS_PER_PAIR)
        record("systolic_eval", [n, 26, L], err, ok,
               time_ms(lambda: K1.soc_metrics(vals, layers)),
               time_ms(lambda: K1.soc_metrics_plain(vals, layers)), None, bnd)
        if n == 2500:
            y_pool = out_p

    # --- K2 pairdist: TED (2500 x 2500) and a GP inference block (64 x 2500),
    # D = 26, in the d² mode the main path uses and the fused RBF mode.
    x_all = torch.rand((2500, 26), generator=gen, device=dev)
    for n, m in ((2500, 2500), (64, 2500)):
        x, y = x_all[:n].contiguous(), x_all.flip(0)[:m].contiguous()
        scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
        # cancellation in |x|^2+|y|^2-2xy: float32 error up to ~D*2^-24 of
        # the norms, so atol = 2*D*2^-24*scale
        atol = 2 * 26 * 2.0 ** -24 * scale
        bw = 1.3
        inv2s2 = 1.0 / (2 * bw * bw + 1e-12)
        for bandwidth, tol in ((None, atol), (bw, inv2s2 * atol + 1e-6)):
            out_k = K2.pairdist(x, y, bandwidth=bandwidth)
            out_p = K2.pairdist_plain(x, y, bandwidth)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            ok = bool(torch.allclose(out_k, out_p, rtol=1e-5, atol=tol))
            ops = 2 * n * m * 26 + 3 * n * m + 2 * (n + m) * 26 \
                + (2 * n * m if bandwidth else 0)
            bnd = bound_ms(4 * ((n + m) * 26 + n * m), ops)
            lib = (time_ms(lambda: torch.cdist(x, y)) if bandwidth is None
                   else None)
            record("pairdist" if bandwidth is None else "pairdist_rbf",
                   [n, m, 26], err, ok,
                   time_ms(lambda: K2.pairdist(x, y, bandwidth=bandwidth)),
                   time_ms(lambda: K2.pairdist_plain(x, y, bandwidth)),
                   lib, bnd)

    # --- K3 pareto_count: the reference front's N=2500, m=3, with the last
    # 500 rows duplicates of the first 500 (ties dominate nothing).
    yd = torch.cat([y_pool[:2000], y_pool[:500]]).contiguous()
    c_k = K3.dominance_counts(yd)
    c_p = K3.dominance_counts_plain(yd)
    torch.cuda.synchronize()
    ok = bool(torch.equal(c_k, c_p))  # integer counts: exactly equal
    err = float((c_k - c_p).abs().max())
    n = yd.shape[0]
    record("pareto_count", [n, 3], err, ok,
           time_ms(lambda: K3.dominance_counts(yd)),
           time_ms(lambda: K3.dominance_counts_plain(yd)), None,
           bound_ms(4 * (n * 3 + n), n * n * K3_OPS_PER_PAIR(3)))
    assert int((c_k == 0).sum()) > 0 and np.isfinite(yd.cpu().numpy()).all()
    return results


def run_tuner(cfg: dict, device, draws=None, pool_device=None):
    """One soc_tuner run through the user's entry points; returns
    (result, pool, reference front, flow). The pool is sampled on
    ``pool_device`` (default: ``device``)."""
    import torch

    from repro_torch.core import make_space, pareto_front, soc_tuner
    from repro_torch.soc import VLSIFlow

    space = make_space()
    gen = torch.Generator(device=pool_device or device).manual_seed(cfg["seed"])
    pool = space.sample(gen, cfg["n_pool"]).cpu().numpy()
    ref = pareto_front(VLSIFlow(space, cfg["workload"], device=device)(pool),
                       device=device)
    flow = VLSIFlow(space, cfg["workload"], device=device)
    kw = {k: cfg[k] for k in ("T", "n", "b", "gp_steps", "s_frontiers",
                              "frontier_subset")}
    res = soc_tuner(space, pool, flow, reference_front=ref,
                    seed=cfg["seed"], draws=draws, device=device, **kw)
    return res, pool, ref, flow


def check_result(res, pool, ref, cfg) -> None:
    """The repo's own means: finite metrics of the right shape that the
    plain SoC model (on the CPU) reproduces, a full history, a finite ADRS
    that the Pareto front of the evaluated rows reproduces."""
    import numpy as np

    from repro_torch.core import adrs, make_space
    from repro_torch.soc import VLSIFlow

    rows = res.evaluated_rows
    assert len(rows) == len(set(rows.tolist())), "a row was evaluated twice"
    assert res.y.shape == (len(rows), 3) and np.isfinite(res.y).all()
    assert len(res.history) == cfg["T"] + 1
    y_cpu = VLSIFlow(make_space(), cfg["workload"], device="cpu")(pool[rows])
    np.testing.assert_allclose(res.y, y_cpu, rtol=2e-5)
    final = res.history[-1]["adrs"]
    assert np.isfinite(final) and final >= 0.0
    np.testing.assert_allclose(final, adrs(ref, res.pareto_y), rtol=1e-12)


def round_breakdown(res, pool, flow, cfg: dict, dev) -> dict:
    """One more exact round at the main path's final state, stage by stage:
    host-clock seconds (each stage ends in a synchronize) of the GP fit, the
    acquisition (posterior, frontier sampling, scoring) and one flow call.
    The round then runs again under torch.profiler for the device's busy
    seconds and launch count; the busy share divides those by the
    unprofiled round, since the profiler slows the host but not the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fit_gp, imoo_scores, make_space
    from repro_torch.core.sampling import transform_to_icd
    from repro_torch.random import GeneratorDraws

    pool_t = torch.as_tensor(pool, device=dev)
    pool_icd = transform_to_icd(make_space(), res.space.apply_pins(pool_t),
                                res.v).contiguous()
    x = pool_icd[torch.as_tensor(res.evaluated_rows, device=dev)]
    y = torch.as_tensor(-res.y, device=dev)
    sub, eps = GeneratorDraws(1, dev).round(len(pool), cfg["frontier_subset"],
                                            3, cfg["s_frontiers"])
    fc = (pool_icd if sub is None
          else pool_icd[torch.as_tensor(sub, device=dev)].contiguous())

    def one_round() -> list[float]:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        state = fit_gp(x, y, steps=cfg["gp_steps"])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        int(torch.argmax(imoo_scores(state, pool_icd, eps, frontier_cand=fc)))
        t.append(time.perf_counter())
        flow(pool[res.evaluated_rows[-1:]])
        t.append(time.perf_counter())
        return t

    t = one_round()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_round()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in dev_events) * 1e-6
    launches = sum(e.count for e in dev_events)
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(fit_s=t[1] - t[0], acquisition_s=t[2] - t[1],
               flow_s=t[3] - t[2], round_s=t[3] - t[0],
               device_busy_s=dev_s if launches else None,
               device_busy_share=dev_s / (t[3] - t[0]) if launches else None,
               device_launches=launches,
               top_kernels=[(e.key[:60], e.count, e.self_device_time_total)
                            for e in top])
    busy = ("device busy: not measured (the profiler saw no device activity)"
            if not launches else
            f"device busy {dev_s:.3f} s ({100 * out['device_busy_share']:.1f} "
            f"% of the round), {launches} launches")
    print(f"  one round, stage by stage: fit {out['fit_s']:.3f} s "
          f"({cfg['gp_steps']} Adam steps), acquisition "
          f"{out['acquisition_s']:.4f} s, flow {out['flow_s']:.4f} s, round "
          f"{out['round_s']:.3f} s; {busy}")
    for name, count, us in out["top_kernels"]:
        print(f"    {us / 1e3:8.2f} ms {count:6d}x {name}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels import build
    from repro_torch.random import GeneratorDraws

    # IEEE float32 products throughout, never TF32 (the port's rule).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}")

    build.library()
    print(f"kernel build: {build.build_seconds():.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or ("spill" in line and " 0 bytes spill stores, 0"
                                   not in f" {line.strip()}"):
            print("  ptxas:", line.strip())

    print("kernel checks (CUDA events, median, warm L2; device = CUDA-graph "
          "replay, eager = launched from Python):")
    checks = check_kernels(dev)

    print("main path: soc_tuner", json.dumps(MAIN))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res, pool, ref, flow = run_tuner(MAIN, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__.rsplit(".", 1)[1]: k.launches for k in kernels.KERNELS}
    for h in res.history:
        print(f"  round {h['round']:2d} wall_s={h['wall_s']:.3f} "
              f"evals={h['evaluations']} front={h['pareto_size']} "
              f"adrs={h['adrs']:.5f}")
    print(f"  main path: {wall:.1f} s, final ADRS {res.history[-1]['adrs']:.5f}, "
          f"flow evaluations {flow.evaluated} in {flow.calls} calls, "
          f"launches {launches}")
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    check_result(res, pool, ref, MAIN)
    breakdown = round_breakdown(res, pool, flow, MAIN, dev)

    # Small input: the card's run picks what the CPU's plain run picks, with
    # the same draws (seeded on the CPU, handed to both).
    small = {}
    for d in ("cuda", "cpu"):
        small[d] = run_tuner(SMALL, d, GeneratorDraws(SMALL["seed"], "cpu"),
                             pool_device="cpu")
        check_result(*small[d][:3], SMALL)
    r_gpu, r_cpu = small["cuda"][0], small["cpu"][0]
    print(f"small check (n_pool=64, T=6): cuda rows {r_gpu.evaluated_rows.tolist()}")
    print(f"                             cpu  rows {r_cpu.evaluated_rows.tolist()}")
    assert np.array_equal(r_gpu.evaluated_rows, r_cpu.evaluated_rows), \
        "the card's small run picked other rows than the CPU's plain run"
    np.testing.assert_allclose(r_gpu.history[-1]["adrs"],
                               r_cpu.history[-1]["adrs"], rtol=1e-5)

    src = "src/repro_torch/csrc/"
    meta = {
        "systolic_eval": ("systolic_eval.cu",
                          "src/repro/kernels/systolic_eval/kernel.py:33"),
        "pairdist": ("pairdist.cu", "src/repro/kernels/pairdist/kernel.py:36"),
        "pareto_count": ("pareto_count.cu",
                         "src/repro/kernels/pareto_count/kernel.py:34"),
    }
    entries = []
    for name, (cu, replaces) in meta.items():
        head = checks[name][0]
        errs = [c["max_abs_err"] for k in checks if k.startswith(name)
                for c in checks[k]]
        entries.append(dict(
            name=name, route="cuda", source=src + cu, replaces=replaces,
            launches=launches[name], max_abs_err=max(errs), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=head["shape"]))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, torch=torch.__version__, cuda=torch.version.cuda,
            build_s=build.build_seconds(), checks=checks, kernels=entries,
            main=dict(config=MAIN, wall_s=wall, history=res.history,
                      flow_evaluated=flow.evaluated, flow_calls=flow.calls,
                      launches=launches, round_breakdown=breakdown)),
            indent=1))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
