"""``soc-service-torch`` — command-line driver for the port's exploration
service (the twin of the reference's ``soc-service``, same verbs and flags).

It runs on the card unless given ``--device cpu``; the candidate pool is
drawn from a ``torch.Generator`` on that device seeded with ``--pool-seed``
and the exploration draws from ``GeneratorDraws(--seed, device)``.

Verbs (a bare flag list keeps meaning the single-scenario run, so
existing invocations are untouched):

``soc-service-torch [run] --workload ...``
    restartable q-batch exploration of ONE scenario (``service_tuner``)::

        # start (checkpoints every round, disk-cached evaluations)
        soc-service-torch --workload resnet50 --n-pool 1024 --T 40 --q 4 \\
            --workers 4 --checkpoint-dir runs/r50/ckpt \\
            --cache-dir runs/flowcache --out runs/r50/result.json

        # after a crash / SIGKILL: continue bit-exactly from the snapshot
        soc-service-torch ... --resume --out runs/r50/result.json

``soc-service-torch fleet --workloads resnet50,transformer --seeds 0,1 ...``
    the async multi-scenario fleet (``fleet_service``): workloads × seeds
    scenarios over ONE shared worker pool, per-scenario deterministic
    trajectories, same checkpoint/resume story.

``soc-service-torch serve --port 7763 --checkpoint-dir runs/server ...``
    the multi-tenant tuning server (``TunerServer`` + JSON-lines wire
    API): jobs submitted over the wire (or seeded via ``--jobs-file``)
    are multiplexed onto ONE shared worker pool + flow cache, each with
    the same deterministic trajectory it would have alone. A SIGKILL'd
    server restarted with ``--resume`` continues every job bit-exactly.

``soc-service-torch submit|status|metrics|pause|resume|cancel|shutdown --port ..``
    one-shot wire clients for a running server::

        soc-service-torch submit --port 7763 --workload resnet50 --T 40 --q 4
        soc-service-torch status --port 7763
        soc-service-torch metrics --port 7763 --prom   # Prometheus text format
        soc-service-torch pause --port 7763 --job j0000

``soc-service-torch cache-gc --cache-dir ... [--max-bytes N] [--max-age-days D]``
    LRU eviction for the content-addressed flow cache
    (``FlowDiskCache.gc``).

The same binary is the CI smoke driver: ``--kill-after K`` SIGKILLs the
process right after the checkpoint covering K evaluations (crash
simulation), and ``--mock-flow-delay`` wraps the surrogate flow in a fixed
per-call sleep so concurrency effects are visible without a real flow.

Also runnable as ``python -m repro_torch.service.cli``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

__all__ = ["main", "build_parser", "build_fleet_parser",
           "build_serve_parser", "build_client_parser",
           "build_cache_gc_parser"]


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="where the engines and the flow run: cuda (the "
                        "default) or cpu")


def _pool(n_pool: int, pool_seed: int, device):
    """The space and its deterministic pool sample on ``device``."""
    import torch

    from repro_torch.core import make_space

    space = make_space()
    gen = torch.Generator(device=device).manual_seed(pool_seed)
    return space, space.sample(gen, n_pool).cpu().numpy()


def _add_proposer_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--proposer", action="store_true",
                   help="enable the between-round perturbation proposer: "
                        "replace the weakest unevaluated pool columns with "
                        "designs sampled near the current Pareto front "
                        "(requires the incremental engine)")
    p.add_argument("--proposer-every", type=int, default=1,
                   help="propose after every N completed evaluations")
    p.add_argument("--proposer-n", type=int, default=4,
                   help="replacement candidates per proposal step")
    p.add_argument("--proposer-scale", type=float, default=0.15,
                   help="perturbation stddev in the normalized design space")


def _proposer_arg(a) -> dict | None:
    if not getattr(a, "proposer", False):
        return None
    return {"enabled": True, "every": a.proposer_every,
            "n_propose": a.proposer_n, "scale": a.proposer_scale}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="soc-service-torch", description=__doc__)
    p.add_argument("--workload", default="resnet50")
    p.add_argument("--n-pool", type=int, default=1024)
    p.add_argument("--pool-seed", type=int, default=0,
                   help="seed of the pool sample's torch.Generator")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the exploration draws")
    p.add_argument("--T", type=int, default=40,
                   help="BO-phase flow-evaluation budget")
    p.add_argument("--q", type=int, default=1,
                   help="max concurrent evaluations in flight")
    p.add_argument("--min-done", type=int, default=1,
                   help="completions to wait for before the next refill "
                        "(1 = fully async, q = per-round barrier)")
    p.add_argument("--fantasy", default="mean",
                   choices=("mean", "cl_min", "cl_max"))
    p.add_argument("--unordered", action="store_true",
                   help="observe completions as they land instead of in "
                        "submission order (faster, timing-dependent)")
    p.add_argument("--workers", type=int, default=None,
                   help="pool workers (default: q)")
    p.add_argument("--executor", default="process",
                   choices=("process", "thread", "inline"))
    p.add_argument("--n", type=int, default=30)
    p.add_argument("--b", type=int, default=20)
    p.add_argument("--gp-steps", type=int, default=150)
    p.add_argument("--bucket", type=int, default=None,
                   help="engine pad bucket")
    p.add_argument("--pool-chunk", default=None,
                   help="engine pool_chunk: int or 'auto'")
    p.add_argument("--no-incremental", action="store_true",
                   help="run the exact historical engine (forces q=1)")
    p.add_argument("--cache-dir", default=None,
                   help="content-addressed on-disk flow cache root")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mock-flow-delay", type=float, default=None,
                   help="wrap the flow in a per-call sleep of this many "
                        "seconds (mock of a real flow's latency)")
    p.add_argument("--events", default=None,
                   help="append telemetry events (JSON lines) to this "
                        "file; render with repro_torch.obs.build_chrome_trace")
    p.add_argument("--profile-stages", action="store_true",
                   help="profile the engine's per-round stage walls "
                        "(folded into the metrics registry)")
    p.add_argument("--out", default=None,
                   help="write the result (rows, metrics, history, stats) "
                        "as JSON here")
    p.add_argument("--kill-after", type=int, default=None,
                   help="test hook: SIGKILL right after the checkpoint "
                        "covering this many evaluations")
    p.add_argument("--quiet", action="store_true")
    _add_device_flag(p)
    _add_proposer_flags(p)
    return p


def build_fleet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="soc-service-torch fleet",
        description="async multi-scenario exploration over one worker pool")
    p.add_argument("--workloads", default="resnet50",
                   help="comma-separated workload names")
    p.add_argument("--seeds", default="0",
                   help="comma-separated exploration seeds; scenarios = "
                        "workloads x seeds")
    p.add_argument("--n-pool", type=int, default=1024)
    p.add_argument("--pool-seed", type=int, default=0,
                   help="seed of the pool sample's torch.Generator")
    p.add_argument("--T", type=int, default=40,
                   help="BO-phase flow-evaluation budget PER SCENARIO")
    p.add_argument("--q", type=int, default=1,
                   help="max concurrent evaluations in flight per scenario")
    p.add_argument("--min-done", type=int, default=1,
                   help="completions each scenario awaits per cycle "
                        "(1 = fully async, q = per-scenario barrier)")
    p.add_argument("--fantasy", default="mean",
                   choices=("mean", "cl_min", "cl_max"))
    p.add_argument("--workers", type=int, default=None,
                   help="shared pool workers (default: q x scenarios, "
                        "capped at the CPU count)")
    p.add_argument("--executor", default="process",
                   choices=("process", "thread", "inline"))
    p.add_argument("--n", type=int, default=30)
    p.add_argument("--b", type=int, default=20)
    p.add_argument("--gp-steps", type=int, default=150)
    p.add_argument("--bucket", type=int, default=None,
                   help="engine pad bucket")
    p.add_argument("--pool-chunk", default=None,
                   help="engine pool_chunk: int or 'auto'")
    p.add_argument("--cache-dir", default=None,
                   help="content-addressed on-disk flow cache root")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--mock-flow-delay", type=float, default=None,
                   help="wrap every flow in a per-call sleep of this many "
                        "seconds (mock of a real flow's latency)")
    p.add_argument("--events", default=None,
                   help="append telemetry events (JSON lines) to this "
                        "file; render with repro_torch.obs.build_chrome_trace")
    p.add_argument("--out", default=None,
                   help="write per-scenario results as JSON here")
    p.add_argument("--kill-after", type=int, default=None,
                   help="test hook: SIGKILL right after the checkpoint "
                        "covering this many TOTAL fleet evaluations")
    p.add_argument("--quiet", action="store_true")
    _add_device_flag(p)
    _add_proposer_flags(p)
    return p


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="soc-service-torch serve",
        description="multi-tenant tuning server over one shared worker "
                    "pool (JSON-lines-over-TCP control plane)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="TCP port for the wire API (0 = pick a free one)")
    p.add_argument("--port-file", default=None,
                   help="write the bound port here once listening (for "
                        "--port 0 automation)")
    p.add_argument("--n-pool", type=int, default=1024)
    p.add_argument("--pool-seed", type=int, default=0,
                   help="seed of the pool sample's torch.Generator")
    p.add_argument("--workers", type=int, default=4,
                   help="shared pool workers")
    p.add_argument("--executor", default="process",
                   choices=("process", "thread", "inline"))
    p.add_argument("--max-active", type=int, default=None,
                   help="cap on concurrently RUNNING (engine-resident) "
                        "jobs; default unlimited")
    p.add_argument("--retries", type=int, default=0,
                   help="per-design re-dispatch budget for failed flow "
                        "evaluations")
    p.add_argument("--cache-dir", default=None,
                   help="content-addressed on-disk flow cache root")
    p.add_argument("--checkpoint-dir", default=None,
                   help="server manifest + per-job snapshot root (required "
                        "for crash recovery)")
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--resume", action="store_true",
                   help="reload the job table from the manifest and resume "
                        "every live job bit-exactly")
    p.add_argument("--jobs-file", default=None,
                   help="JSON list of job spec dicts to submit at startup "
                        "(skipped when --resume finds an existing job "
                        "table)")
    p.add_argument("--drain-exit", action="store_true",
                   help="exit once every submitted job has settled "
                        "(DONE/FAILED/CANCELLED) instead of serving "
                        "forever")
    p.add_argument("--poll-s", type=float, default=0.05,
                   help="idle wire-poll interval in seconds")
    p.add_argument("--mock-flow-delay", type=float, default=None,
                   help="wrap every flow in a per-call sleep of this many "
                        "seconds (mock of a real flow's latency)")
    p.add_argument("--events", default=None,
                   help="append telemetry events (JSON lines) to this "
                        "file; a resumed server appends a new generation")
    p.add_argument("--out", default=None,
                   help="write per-job results as JSON here on exit")
    p.add_argument("--kill-after", type=int, default=None,
                   help="test hook: SIGKILL right after the checkpoint "
                        "covering this many TOTAL server evaluations")
    p.add_argument("--quiet", action="store_true")
    _add_device_flag(p)
    return p


def build_client_parser(verb: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=f"soc-service-torch {verb}",
        description=f"send one '{verb}' request to a running server")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--timeout", type=float, default=120.0)
    if verb in ("pause", "resume", "cancel"):
        p.add_argument("--job", required=True)
    elif verb == "status":
        p.add_argument("--job", default=None)
    elif verb == "metrics":
        p.add_argument("--prom", action="store_true",
                       help="render the snapshot as Prometheus text "
                            "exposition format instead of JSON")
    elif verb == "submit":
        p.add_argument("--spec", default=None,
                       help="full JSON spec dict (overrides the flags "
                            "below)")
        p.add_argument("--workload", default="resnet50")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--weights", default=None,
                       help="comma-separated objective weights, e.g. "
                            "'1,2,1'")
        p.add_argument("--T", type=int, default=40)
        p.add_argument("--q", type=int, default=1)
        p.add_argument("--min-done", type=int, default=1)
        p.add_argument("--fantasy", default="mean",
                       choices=("mean", "cl_min", "cl_max"))
        p.add_argument("--priority", type=int, default=0)
        p.add_argument("--n", type=int, default=30)
        p.add_argument("--b", type=int, default=20)
        p.add_argument("--gp-steps", type=int, default=150)
        _add_proposer_flags(p)
    return p


def build_cache_gc_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="soc-service-torch cache-gc",
        description="LRU eviction for the on-disk flow cache")
    p.add_argument("--cache-dir", required=True)
    p.add_argument("--max-bytes", type=int, default=None,
                   help="evict LRU entries until the cache fits this budget")
    p.add_argument("--max-age-days", type=float, default=None,
                   help="evict entries unused for longer than this")
    p.add_argument("--dry-run", action="store_true",
                   help="report what would be evicted without deleting")
    p.add_argument("--quiet", action="store_true")
    return p


def main_fleet(argv=None) -> int:
    a = build_fleet_parser().parse_args(argv)
    from repro_torch.core import FleetScenario
    from repro_torch.device import resolve_device
    from repro_torch.soc import DelayedFlow, VLSIFlow
    from .fleet_runner import fleet_service

    dev = resolve_device(a.device)
    space, pool = _pool(a.n_pool, a.pool_seed, dev)
    scenarios = [FleetScenario(wl.strip(), seed=int(s))
                 for wl in a.workloads.split(",")
                 for s in a.seeds.split(",")]
    delay = a.mock_flow_delay
    if delay is not None:
        flow_factory = lambda wl: DelayedFlow(VLSIFlow(space, wl, device=dev),
                                              delay)
    else:
        flow_factory = None
    pool_chunk = a.pool_chunk
    if pool_chunk not in (None, "auto"):
        pool_chunk = int(pool_chunk)

    fr = fleet_service(
        space, pool, scenarios, T=a.T, q=a.q, min_done=a.min_done,
        fantasy=a.fantasy, max_workers=a.workers, executor=a.executor,
        n=a.n, b=a.b, gp_steps=a.gp_steps, bucket=a.bucket,
        pool_chunk=pool_chunk, flow_factory=flow_factory,
        cache_dir=a.cache_dir, checkpoint_dir=a.checkpoint_dir,
        checkpoint_every=a.checkpoint_every, resume=a.resume,
        proposer=_proposer_arg(a), device=dev,
        verbose=not a.quiet, events=a.events, _kill_after=a.kill_after)

    if not a.quiet:
        for sc, res in zip(fr.scenarios, fr.results):
            print(f"[fleet-svc] {sc.label}: {len(res.evaluated_rows)} "
                  f"evaluations, {res.pareto_y.shape[0]} Pareto points")
        print(f"[fleet-svc] {fr.cache.summary()}")
        print(f"[fleet-svc] wall {fr.wall_s:.1f}s")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({
                "scenarios": {
                    sc.label: {
                        "evaluated_rows": [int(r)
                                           for r in res.evaluated_rows],
                        "y": np.asarray(res.y, np.float64).tolist(),
                        "pareto_rows": [int(r) for r in res.pareto_rows],
                        "history": res.history,
                    } for sc, res in zip(fr.scenarios, fr.results)},
                "engine_stats": fr.results[0].engine_stats,
                "wall_s": fr.wall_s,
            }, f, indent=2)
        if not a.quiet:
            print(f"[fleet-svc] result -> {a.out}")
    return 0


def main_serve(argv=None) -> int:
    a = build_serve_parser().parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.soc import DelayedFlow, VLSIFlow
    from .jobs import JobSpec
    from .server import TunerServer, serve

    dev = resolve_device(a.device)
    space, pool = _pool(a.n_pool, a.pool_seed, dev)
    delay = a.mock_flow_delay
    if delay is not None:
        flow_factory = lambda wl: DelayedFlow(VLSIFlow(space, wl, device=dev),
                                              delay)
    else:
        flow_factory = None

    server = TunerServer(
        space, pool, max_workers=a.workers, executor=a.executor,
        flow_factory=flow_factory, cache_dir=a.cache_dir,
        checkpoint_dir=a.checkpoint_dir, checkpoint_every=a.checkpoint_every,
        max_active=a.max_active, retries=a.retries, resume=a.resume,
        verbose=not a.quiet, events=a.events, device=dev,
        _kill_after=a.kill_after)
    if a.jobs_file and not server.jobs:
        with open(a.jobs_file) as f:
            for spec in json.load(f):
                server.submit(JobSpec.from_dict(spec))

    def ready(port):
        if a.port_file:
            tmp = a.port_file + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(port))
            os.replace(tmp, a.port_file)

    try:
        serve(server, a.host, a.port, drain_exit=a.drain_exit,
              poll_s=a.poll_s, ready_cb=ready)
    finally:
        server.close()

    if not a.quiet:
        for job in server.jobs.values():
            print(f"[server] {job.label}: {job.status} "
                  f"({job.done}/{job.spec.T} evaluations)")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({
                "jobs": {
                    jid: {"label": job.label, "status": job.status,
                          "error": job.error, **(job.result_dict() or {})}
                    for jid, job in server.jobs.items()},
                "status": server.status(),
            }, f, indent=2)
        if not a.quiet:
            print(f"[server] results -> {a.out}")
    return 0


def main_client(verb: str, argv=None) -> int:
    a = build_client_parser(verb).parse_args(argv)
    from .server import request

    req: dict = {"verb": verb}
    if verb in ("pause", "resume", "cancel"):
        req["job"] = a.job
    elif verb == "status" and a.job is not None:
        req["job"] = a.job
    elif verb == "submit":
        if a.spec is not None:
            spec = json.loads(a.spec)
        else:
            spec = {"workload": a.workload, "seed": a.seed, "T": a.T,
                    "q": a.q, "min_done": a.min_done, "fantasy": a.fantasy,
                    "priority": a.priority, "n": a.n, "b": a.b,
                    "gp_steps": a.gp_steps}
            if a.weights is not None:
                spec["weights"] = [float(w) for w in a.weights.split(",")]
            prop = _proposer_arg(a)
            if prop is not None:
                spec["proposer"] = prop
        req["spec"] = spec
    reply = request(a.port, req, host=a.host, timeout=a.timeout)
    if verb == "metrics" and getattr(a, "prom", False) and reply.get("ok"):
        # the snapshot IS the wire payload; Prometheus text is a pure
        # client-side rendering of it.
        from repro_torch.obs import render_prometheus

        print(render_prometheus(reply["metrics"]), end="")
        return 0
    print(json.dumps(reply, indent=2))
    return 0 if reply.get("ok") else 1


def main_cache_gc(argv=None) -> int:
    a = build_cache_gc_parser().parse_args(argv)
    from .flowcache import FlowDiskCache

    cache = FlowDiskCache(a.cache_dir)
    stats = cache.gc(max_bytes=a.max_bytes, max_age_days=a.max_age_days,
                     dry_run=a.dry_run)
    if not a.quiet:
        verb = "would evict" if a.dry_run else "evicted"
        print(f"[cache-gc] {a.cache_dir}: {verb} {stats['removed']}/"
              f"{stats['scanned']} entries ({stats['removed_bytes']} bytes), "
              f"{stats['kept']} kept ({stats['kept_bytes']} bytes)")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "fleet":
        return main_fleet(argv[1:])
    if argv and argv[0] == "serve":
        return main_serve(argv[1:])
    if argv and argv[0] in ("submit", "status", "metrics", "pause",
                            "resume", "cancel", "shutdown"):
        return main_client(argv[0], argv[1:])
    if argv and argv[0] == "cache-gc":
        return main_cache_gc(argv[1:])
    if argv and argv[0] == "run":
        argv = argv[1:]
    a = build_parser().parse_args(argv)
    from repro_torch.device import resolve_device
    from repro_torch.soc import DelayedFlow, VLSIFlow
    from .runner import service_tuner

    dev = resolve_device(a.device)
    space, pool = _pool(a.n_pool, a.pool_seed, dev)
    flow = VLSIFlow(space, a.workload, device=dev)
    if a.mock_flow_delay is not None:
        flow = DelayedFlow(flow, a.mock_flow_delay)
    pool_chunk = a.pool_chunk
    if pool_chunk not in (None, "auto"):
        pool_chunk = int(pool_chunk)
    q = a.q
    if a.no_incremental and q > 1:
        # the help text promises this: the exact historical engine has no
        # fantasy machinery, so the run degenerates to sequential rounds
        print(f"[service] --no-incremental forces q=1 (requested q={q})")
        q = 1

    res = service_tuner(
        space, pool, flow, workload=a.workload, T=a.T, q=q,
        fantasy=a.fantasy, min_done=min(a.min_done, q),
        ordered=not a.unordered,
        max_workers=a.workers, executor=a.executor, n=a.n, b=a.b,
        gp_steps=a.gp_steps, seed=a.seed, device=dev,
        incremental=not a.no_incremental, bucket=a.bucket,
        pool_chunk=pool_chunk, cache_dir=a.cache_dir,
        checkpoint_dir=a.checkpoint_dir, checkpoint_every=a.checkpoint_every,
        resume=a.resume, proposer=_proposer_arg(a), verbose=not a.quiet,
        events=a.events, profile_stages=a.profile_stages,
        _kill_after=a.kill_after)

    if not a.quiet:
        print(f"[service] {len(res.evaluated_rows)} evaluations, "
              f"{res.pareto_y.shape[0]} Pareto points, "
              f"wall {res.wall_s:.1f}s")
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({
                "evaluated_rows": [int(r) for r in res.evaluated_rows],
                "y": np.asarray(res.y, np.float64).tolist(),
                "pareto_rows": [int(r) for r in res.pareto_rows],
                "history": res.history,
                "engine_stats": res.engine_stats,
                "wall_s": res.wall_s,
            }, f, indent=2)
        if not a.quiet:
            print(f"[service] result -> {a.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
