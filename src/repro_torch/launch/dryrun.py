"""Multi-pod dry run: every (arch x shape) cell run once on the production
mesh over a fake process group, with its per-device statistics
(``repro.launch.dryrun``).

The proof that the distribution config is coherent at 256/512 ranks
without the hardware: a spec that does not divide, an op with no sharded
rule or a shape mismatch between shards fails here. The reference lowers
and compiles each cell for 512 forced host devices; the port runs it
eagerly on DTensors over a fake process group of the mesh's size (this
process rank 0) under ``FakeTensorMode``, and counts what this rank runs
(``launch.program_stats``). One process per cell, as the reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k --mesh multi --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --jobs 6 --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

__all__ = ["run_cell", "record_of"]

#: the runner's default output directory (under the git-ignored results/)
OUT = "results/dryrun_torch"


def record_of(arch: str, shape: str, mesh_name: str, stats, cfg,
              devices: int, run_s: float) -> dict:
    """The reference's record for a cell, from a ``ProgramStats``; fields
    with no faithful counterpart are left out (``program_stats``)."""
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name, "status": "ok",
        "devices": int(devices),
        "run_s": round(run_s, 1),
        "dot_flops": stats.dot_flops,
        "dot_bytes": stats.dot_bytes,
        "collective_bytes": {k: float(v) for k, v in
                             sorted(stats.coll_bytes.items())},
        "collective_counts": {k: int(v) for k, v in
                              sorted(stats.coll_counts.items())},
        "collective_total": stats.coll_total,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "argument_size_in_bytes": int(stats.argument_bytes),
        "output_size_in_bytes": int(stats.output_bytes),
        "temp_size_in_bytes": int(stats.temp_bytes),
        "peak_size_in_bytes": int(stats.peak_bytes),
    }


def run_cell(arch: str, shape, mesh_name: str,
             overrides: dict | None = None) -> dict:
    """Run one cell once over the fake process group; return its record
    (``status`` "skip" for a cell the skip matrix excludes). ``shape`` is a
    key of ``SHAPES`` or a ``ShapeSpec`` (the tests' small shapes)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import SHAPES, cell_skip_reason
    from repro_torch.parallel.sharding import axis_rules, mixed_with_dtensors
    from .mesh import make_mesh_named
    from .program_stats import Counter, fake_safe_dtensor
    from .specs import build_cell, cell_rules

    spec = SHAPES[shape] if isinstance(shape, str) else shape
    shape = spec.name
    skip = cell_skip_reason(arch, shape)
    if skip:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skip", "reason": skip}
    t0 = time.time()
    mesh = make_mesh_named(mesh_name, fake=True)
    rules_over = cell_rules(spec, arch)
    overrides = dict(overrides or {})
    if "rules" in overrides:
        rules_over = dict(rules_over)
        rules_over.update({k: tuple(tuple(c) for c in v)
                           for k, v in overrides.pop("rules").items()})
    with axis_rules(mesh, rules_over) as rules, fake_safe_dtensor(), \
            FakeTensorMode(allow_non_fake_inputs=True):
        cell = build_cell(arch, spec, rules, overrides)
        counter = Counter()
        counter.track(cell.args)
        counter.track(cell.held, argument=False)
        with counter, mixed_with_dtensors():
            out = cell.fn(*cell.args)
        counter.finish(out)
        cfg = cell.cfg
        del out, cell
    torch.distributed.destroy_process_group()
    return record_of(arch, shape, mesh_name, counter.stats, cfg,
                     mesh.devices.size, time.time() - t0)


def _worker_main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--overrides", default="{}")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        f"{args.arch}__{args.shape}__{args.mesh}.json")
    try:
        rec = run_cell(args.arch, args.shape, args.mesh,
                       json.loads(args.overrides))
    except Exception as e:  # recorded, not raised: the runner aggregates
        rec = {"arch": args.arch, "shape": args.shape, "mesh": args.mesh,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-4000:]}
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: v for k, v in rec.items() if k != "trace"}))
    return 0 if rec.get("status") in ("ok", "skip") else 1


def _runner_main(args) -> int:
    """Every cell in a subprocess of its own (each needs its own process
    group; N workers run N cells at once)."""
    from repro_torch.configs import ARCH_IDS, SHAPES
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in meshes]
    pending = []
    for a, s, m in cells:
        path = os.path.join(args.out, f"{a}__{s}__{m}.json")
        if args.resume and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") in ("ok", "skip"):
                    continue
        pending.append((a, s, m))
    print(f"[dryrun] {len(pending)} cells to run "
          f"({len(cells) - len(pending)} cached)", flush=True)
    procs: list[tuple[subprocess.Popen, tuple]] = []
    fails = 0
    # one intra-op thread a cell: a dry run computes nothing (fake tensors)
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "1"))
    while pending or procs:
        while pending and len(procs) < args.jobs:
            a, s, m = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", a, "--shape", s, "--mesh", m, "--out", args.out]
            procs.append((subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                           env=env), (a, s, m)))
        time.sleep(0.5)
        alive = []
        for pr, cell in procs:
            if pr.poll() is None:
                alive.append((pr, cell))
            else:
                ok = pr.returncode == 0
                fails += (not ok)
                print(f"[dryrun] {'ok  ' if ok else 'FAIL'} {cell}",
                      flush=True)
        procs = alive
    print(f"[dryrun] done; {fails} failures")
    return 1 if fails else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--resume", action="store_true", default=True)
    ap.add_argument("--overrides", default="{}")
    args = ap.parse_args()
    if args.all:
        return _runner_main(args)
    return _worker_main(["--arch", args.arch, "--shape", args.shape,
                         "--mesh", args.mesh, "--out", args.out,
                         "--overrides", args.overrides])


if __name__ == "__main__":
    sys.exit(main())
