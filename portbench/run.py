"""One run of one benchmark cell on this machine's card(s).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's configuration in ``repro_torch`` with weights drawn on
the card from the seed, warms up the cell's own shapes, measures for
``--seconds`` (``--trace 1``: under ``torch.profiler``), checks the served
tokens or the first training steps against the plain reference, and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, last, ``checks`` (each
number compared with its limit; also the last lines on standard error).
Exits non-zero with no result without the card(s) the cell asks for,
outside a checkout of the repository, or if JAX or the JAX package was
loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules a run must not load: JAX and the JAX package
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _environment() -> None:
    """Kernel caches at fixed paths inside the checkout; the checkout's
    ``src`` and root importable."""
    cache = ROOT / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def context(bench, cell_name: str, seed: int, seconds: float, trace: bool, device):
    """What a driver needs for one run of the cell."""
    from portbench.bench import PKG, cell_entry, config_entry, load_json
    from portbench.sizes import Sizes

    cell = cell_entry(bench, cell_name)
    cfg_entry = config_entry(bench, cell["config"])
    config = load_json(ROOT / cfg_entry["file"])
    mix = load_json(PKG / "mixes" / f"{cell['traffic']}.json")
    return types.SimpleNamespace(
        name=cell_name, chips=cell["chips"], config=config, mix=mix,
        sizes=Sizes.from_config(cell["config"], config),
        cell=load_json(PKG / "cells" / f"{cell_name}.json"),
        seed=seed, seconds=seconds, trace=trace, device=device, t0=T0)


def result(bench, ctx, rec: dict) -> dict:
    """The result line of a finished run."""
    import torch

    from portbench.bench import metrics_of, reader
    from portbench.trace import breakdown, busy_s

    rec["sizes"] = ctx.sizes
    metrics = {}
    for m in metrics_of(bench, ctx.name, ctx.trace):
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu", "count": ctx.chips,
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": all(v <= lim for v, lim in rec["checks"].values()),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device}
    tr = rec.get("trace")
    if tr is not None:
        device["busy_s"] = busy_s(tr)
        device["window_s"] = tr["window_s"]
        out["breakdown"] = breakdown(tr, rec["spans"])
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in rec["checks"].items()}
    return out


def run_cell(bench, cell_name: str, seed: int, seconds: float, trace: bool,
             device, **extra) -> dict:
    """Run one cell on ``device`` and return its result line (``extra``
    goes into the driver's context: a test's planted fault)."""
    ctx = context(bench, cell_name, seed, seconds, trace, device)
    vars(ctx).update(extra)
    driver = importlib.import_module(f"portbench.drivers.{ctx.mix['kind']}")
    rec = driver.run(ctx)
    out = result(bench, ctx, rec)
    out["_detail"] = rec.get("check_detail", {})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: no src/repro_torch beside the benchmark: run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    from portbench.bench import cell_entry, load_benchmark, validate

    bench = load_benchmark(ROOT)
    errs = validate(bench, ROOT)
    if errs:
        print("portbench: BENCHMARK.json: " + "; ".join(errs), file=sys.stderr)
        return 2
    import torch

    chips = cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 2
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    detail = out.pop("_detail")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed}: {json.dumps(detail)}",
          file=sys.stderr)
    print(json.dumps(out), flush=True)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
