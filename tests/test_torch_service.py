"""The port's exploration service (``repro_torch.service``: the flow cache,
the pool, fault injection, ``service_tuner``, the CLI) and ``DelayedFlow``
against the live reference on the CPU.

Both packages share one on-disk flow cache (same keys, same files). The
pools, fed the same operations, hand back the same tickets, rows and
results and keep the same counters. ``service_tuner`` with q = 1 and the
inline executor is the port's ``soc_tuner(incremental=True)`` bit for bit;
with q = 2 over worker threads it picks what the reference picks when fed
the reference's key schedule (``JaxKeyDraws``). A run cut right after a
checkpoint (in process, and as a SIGKILLed CLI process) and resumed is the
uninterrupted run bit for bit.
"""
import json
import os
import pickle
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import numpy as np

from repro import obs as obs_j
from repro.core import make_space as make_space_j
from repro.service import FlowDiskCache as FlowDiskCacheJ
from repro.service import FlowPool as FlowPoolJ
from repro.service import CachedFlow as CachedFlowJ
from repro.service import FaultyExecutor as FaultyExecutorJ
from repro.service import FaultyFlow as FaultyFlowJ
from repro.service import InlineExecutor as InlineExecutorJ
from repro.service import service_tuner as service_tuner_j
from repro.soc import VLSIFlow as VLSIFlowJ
from repro_torch import obs
from repro_torch.core import make_space, soc_tuner
from repro_torch.service import (CachedFlow, FaultyExecutor, FaultyFlow,
                                 FlakyError, FlowDiskCache, FlowPool,
                                 InlineExecutor, service_tuner)
from repro_torch.service import cli, runner
from repro_torch.soc import DelayedFlow, VLSIFlow

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_propose import JaxKeyDraws  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: the parity runs' knobs (n_pool 96, T 6, gp_steps 25)
KW = dict(T=6, n=10, b=8, gp_steps=25)
PROP = {"enabled": True, "every": 2}
COUNTERS = ("dispatched", "cache_hits", "inflight_hits", "retried",
            "abandoned", "outstanding")


@pytest.fixture(scope="module")
def pool96():
    return make_space().sample(torch.Generator().manual_seed(7), 96).numpy()


@pytest.fixture(scope="module")
def jax_q2(pool96):
    """The reference's q = 2 runs over worker threads (key 3): without and
    with the proposer."""
    space = make_space_j()
    return {prop: service_tuner_j(
        space, pool96, VLSIFlowJ(space, "resnet50"),
        key=jax.random.PRNGKey(3), q=2, executor="thread",
        proposer=PROP if prop else None, **KW) for prop in (False, True)}


def _strip(history):
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in history]


def _same_run(a, b):
    np.testing.assert_array_equal(a.evaluated_rows, b.evaluated_rows)
    np.testing.assert_array_equal(a.y, b.y)
    assert _strip(a.history) == _strip(b.history)
    keys = ("rounds", "refactors", "block_updates", "fantasy_steps",
            "frontier_resamples", "pool_replacements")
    assert {k: a.engine_stats[k] for k in keys} == \
        {k: b.engine_stats[k] for k in keys}


def _counts(stats: dict) -> dict:
    """A stats dict without its wall times."""
    return {k: v for k, v in stats.items() if k != "wall_s"}


def _fake_flow(idx):
    """A cheap deterministic flow: idx [k, d] -> y [k, 3]."""
    idx = np.atleast_2d(np.asarray(idx))
    return np.stack([idx.sum(1), idx[:, 0] + 1.0, idx[:, 1] * 0.5],
                    1).astype(np.float32)


# ------------------------------------------------------------- disk cache
def test_disk_cache_entries_are_shared_by_both_packages(tmp_path):
    """One cache directory serves both packages: same keys and files, and
    each reads what the other wrote; ``gc`` and the counters agree."""
    idx = np.random.default_rng(0).integers(0, 9, (6, 26))
    y = np.random.default_rng(1).random((6, 3)).astype(np.float32)
    for row in idx:
        assert FlowDiskCache.key("resnet50", row) == \
            FlowDiskCacheJ.key("resnet50", row)
    assert FlowDiskCache.key("a", idx[0]) != FlowDiskCache.key("b", idx[0])
    port, ref = FlowDiskCache(tmp_path / "c"), FlowDiskCacheJ(tmp_path / "c")
    for i in range(3):
        port.put("resnet50", idx[i], y[i])
        ref.put("transformer", idx[i + 3], y[i + 3])
    k = FlowDiskCache.key("resnet50", idx[0])
    assert os.path.isfile(tmp_path / "c" / k[:2] / f"{k}.npy")
    for i in range(3):
        a = ref.get("resnet50", idx[i])
        b = port.get("transformer", idx[i + 3])
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, y[i])
        np.testing.assert_array_equal(b, y[i + 3])
    assert port.get("resnet50", idx[5]) is None
    assert ref.get("resnet50", idx[5]) is None
    assert port.counters() == {**ref.counters(), "hits": 3, "misses": 1} \
        and ref.counters()["hits"] == 3
    assert sorted(e[:2] for e in port.entries()) == \
        sorted(e[:2] for e in ref.entries())
    reg, reg_j = obs.MetricsRegistry(), obs_j.MetricsRegistry()
    port.bind_metrics(reg)
    ref.bind_metrics(reg_j)
    assert reg.snapshot()["gauges"]["flow_disk_puts"] == \
        reg_j.snapshot()["gauges"]["flow_disk_puts"]
    assert port.gc(max_bytes=0, dry_run=True) == \
        ref.gc(max_bytes=0, dry_run=True)
    assert port.gc(max_bytes=0)["removed"] == 6 and not port.entries()
    with pytest.raises(ValueError, match="max_bytes and/or max_age_days"):
        port.gc()
    assert port.summary().startswith(f"disk cache [{tmp_path / 'c'}]")


def test_cached_flow_reads_through_and_writes_back(tmp_path):
    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(1), 12).numpy()
    flow = VLSIFlow(space, "resnet50", device="cpu")
    cf = CachedFlow(flow, str(tmp_path), "resnet50")
    y = cf(pool[:5])
    np.testing.assert_array_equal(y, flow(pool[:5]))
    np.testing.assert_array_equal(cf(pool[2:8]), flow(pool[2:8]))
    assert cf.flow_calls == 2 and flow.evaluated == 5 + 5 + 3 + 6
    # the reference's wrapper finds every entry the port wrote
    calls = []
    cf_j = CachedFlowJ(lambda i: calls.append(i) or _fake_flow(i),
                       FlowDiskCacheJ(str(tmp_path)), "resnet50")
    np.testing.assert_array_equal(cf_j(pool[:8]), flow(pool[:8]))
    assert calls == [] and cf_j.flow_calls == 0
    back = pickle.loads(pickle.dumps(cf))
    np.testing.assert_array_equal(back(pool[:3]), y[:3])


# ------------------------------------------------------------------- pool
def _drive_pool(pkg_pool, cache_root, executor, pool_idx):
    """One fixed sequence of pool operations; returns what it observed."""
    reg = (obs if pkg_pool is FlowPool else obs_j).MetricsRegistry()
    p = pkg_pool(_fake_flow, workload="w", executor=executor, max_workers=2,
                 cache=cache_root, metrics=reg)
    seen = []

    def take(items):
        seen.append([(t, r, np.asarray(y).tolist()) for t, r, y in items])

    t0 = p.submit(5, pool_idx[5])
    p.submit(7, pool_idx[7])
    p.submit(5, pool_idx[5])                        # in flight: shared
    t3 = p.submit_resolved(9, np.ones(3, np.float32))
    take(p.drain(min_done=2))
    take(p.collect([t3, t0 + 2]))
    t4 = p.submit(11, pool_idx[11])
    p.submit(12, pool_idx[12], workload="other", flow=_fake_flow)
    assert p.abandon([t4, 999]) == 1
    take(p.drain(min_done=5))
    p.submit(7, pool_idx[7])                        # now on the disk
    take(p.drain(min_done=1, ordered=False))
    p.close()
    counts = {k: getattr(p, k) for k in COUNTERS}
    snap = reg.snapshot()
    return seen, counts, {k: snap[k] for k in ("counters", "gauges")}


@pytest.mark.parametrize("executor", ["inline", "thread"])
def test_pool_tickets_dedup_and_counters_equal_the_reference(
        tmp_path, executor):
    pool_idx = np.random.default_rng(2).integers(0, 6, (16, 26))
    got = _drive_pool(FlowPool, str(tmp_path / "a"), executor, pool_idx)
    want = _drive_pool(FlowPoolJ, str(tmp_path / "b"), executor, pool_idx)
    assert got == want
    seen, counts, _ = got
    assert [t for batch in seen for t, _, _ in batch] == [0, 1, 3, 2, 5, 6]
    assert counts == {"dispatched": 4, "cache_hits": 1, "inflight_hits": 1,
                      "retried": 0, "abandoned": 1, "outstanding": 0}


@pytest.mark.parametrize("fault", ["flow", "executor", "exhausted"])
def test_pool_retries_equal_the_reference(fault):
    """A failed dispatch is retried transparently at drain; past the budget
    the failure surfaces there. A second submit of the failed design gets
    a fresh dispatch (the failure never poisons the dedup key)."""
    out = []
    for Pool, Flaky, Faulty, Inline in (
            (FlowPool, FaultyFlow, FaultyExecutor, InlineExecutor),
            (FlowPoolJ, FaultyFlowJ, FaultyExecutorJ, InlineExecutorJ)):
        flow = Flaky(_fake_flow, fail_calls=[0] if fault != "executor"
                     else [])
        ex = (Faulty(Inline(), fail_submissions=[0]) if fault == "executor"
              else "inline")
        p = Pool(flow, executor=ex, retries=0 if fault == "exhausted" else 1)
        p.submit(0, np.arange(26))
        if fault == "exhausted":
            with pytest.raises(Exception, match="injected") as exc:
                p.drain(min_done=1)
            out.append((type(exc.value).__name__, p.dispatched, p.retried))
            continue
        res = p.drain(min_done=1)
        p.submit(1, np.arange(26) + 1)
        p.submit(1, np.arange(26) + 1)
        res += p.drain(min_done=2)
        out.append(([(t, r, y.tolist()) for t, r, y in res], p.dispatched,
                    p.retried, p.inflight_hits))
    assert out[0] == out[1]
    if fault == "exhausted":
        assert out[0] == (FlakyError.__name__, 1, 0)
    else:
        assert out[0][1:] == (3, 1, 1)


def test_pool_refuses_fork_after_cuda_init(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(ValueError, match="fork"):
        FlowPool(_fake_flow, executor="process", mp_context="fork")
    with pytest.raises(ValueError, match="unknown executor"):
        FlowPool(_fake_flow, executor="gpu")


def test_delayed_flow_pickles_and_flow_counts_are_exact_under_threads():
    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(3), 8).numpy()
    flow = VLSIFlow(space, "transformer", device="cpu")
    slow = DelayedFlow(flow, 0.0)
    back = pickle.loads(pickle.dumps(slow))
    assert isinstance(back.flow, VLSIFlow) and back.delay_s == 0.0
    np.testing.assert_array_equal(back(pool), flow(pool))

    def hammer():
        for _ in range(25):
            flow(pool[:2])
    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (flow.calls, flow.evaluated) == (1 + 200, 8 + 400)


def test_kernel_library_loads_once_under_concurrent_first_calls(
        monkeypatch, tmp_path):
    """A pool's worker threads may all launch K1 first at once: the library
    is built and loaded by one of them, and every caller gets it."""
    from repro_torch.kernels import build

    loads = []

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    def slow_cdll(path):
        loads.append(path)
        time.sleep(0.05)
        return FakeLib()
    target = tmp_path / "lib.so"
    target.write_bytes(b"")
    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "library_path", lambda: target)
    monkeypatch.setattr(build.ctypes, "CDLL", slow_cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(build.library()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(loads) == 1 and len(got) == 8
    assert all(lib is got[0] for lib in got)


# ---------------------------------------------------------- service_tuner
def test_q1_inline_is_the_incremental_soc_tuner_bit_for_bit(pool96,
                                                            tmp_path):
    space = make_space()
    kw = dict(KW, device="cpu", seed=5)
    want = soc_tuner(space, pool96, VLSIFlow(space, device="cpu"),
                     incremental=True, **kw)
    flow = VLSIFlow(space, device="cpu")
    got = service_tuner(space, pool96, flow, q=1, executor="inline",
                        cache_dir=str(tmp_path), events=str(tmp_path / "e"),
                        **kw)
    _same_run(got, want)
    assert got.engine_stats["service"]["pool_dispatched"] == KW["T"]
    assert flow.calls == 2 + KW["T"]  # ICD trials, TED init, one a round
    rounds = [r for r in obs.read_events(str(tmp_path / "e"))
              if r["name"] == "round"]
    assert [r["round"] for r in rounds] == list(range(KW["T"] + 1))


@pytest.mark.parametrize("proposer", [False, True])
def test_q2_threads_pick_what_the_reference_picks(pool96, jax_q2, proposer):
    space = make_space()
    got = service_tuner(space, pool96, VLSIFlow(space, device="cpu"),
                        draws=JaxKeyDraws(jax.random.PRNGKey(3)), q=2,
                        executor="thread", proposer=PROP if proposer else None,
                        device="cpu", **KW)
    want = jax_q2[proposer]
    np.testing.assert_array_equal(got.evaluated_rows, want.evaluated_rows)
    # metrics from two float32 SoC models
    np.testing.assert_allclose(got.y, want.y, rtol=1e-5)
    assert [h["pareto_size"] for h in got.history] == \
        [h["pareto_size"] for h in want.history]
    keys = ("rounds", "refactors", "block_updates", "fantasy_steps",
            "frontier_resamples", "service")
    assert {k: got.engine_stats[k] for k in keys} == \
        {k: want.engine_stats[k] for k in keys}
    if proposer:
        assert _counts(got.engine_stats["proposer"]) == \
            _counts(want.engine_stats["proposer"])
        assert got.engine_stats["proposer"]["replaced"] > 0


@pytest.mark.parametrize("proposer", [False, True])
def test_resume_after_a_crash_is_bit_for_bit(pool96, tmp_path, monkeypatch,
                                             proposer):
    """``_kill_after`` cut in process: the kill is turned into an exception
    right after the covering checkpoint; the resumed run (same arguments)
    is the uninterrupted run bit for bit."""
    space = make_space()
    kw = dict(KW, q=2, executor="thread", device="cpu", seed=1,
              proposer=PROP if proposer else None)
    want = service_tuner(space, pool96, VLSIFlow(space, device="cpu"), **kw)

    class Killed(Exception):
        pass

    def kill(pid, sig):
        assert (pid, sig) == (os.getpid(), signal.SIGKILL)
        raise Killed
    d = str(tmp_path / "ckpt")
    with monkeypatch.context() as mp:
        mp.setattr(runner.os, "kill", kill)
        with pytest.raises(Killed):
            service_tuner(space, pool96, VLSIFlow(space, device="cpu"),
                          checkpoint_dir=d, _kill_after=3, **kw)
    got = service_tuner(space, pool96, VLSIFlow(space, device="cpu"),
                        checkpoint_dir=d, resume=True, **kw)
    _same_run(got, want)
    if proposer:
        np.testing.assert_array_equal(got.pool_live, want.pool_live)
        assert _counts(got.engine_stats["proposer"]) == \
            _counts(want.engine_stats["proposer"])


@pytest.mark.parametrize("kw,match", [
    (dict(q=0), "q must be >= 1"), (dict(q=2, incremental=False), "q > 1"),
    (dict(q=2, min_done=3), "min_done"), (dict(fantasy="x"), "fantasy"),
    (dict(proposer=True, incremental=False), "proposer requires")])
def test_bad_arguments_spend_no_flow(kw, match):
    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(0), 16).numpy()
    flow = VLSIFlow(space, device="cpu")
    with pytest.raises(ValueError, match=match):
        service_tuner(space, pool, flow, T=1, n=4, b=2, device="cpu", **kw)
    assert flow.calls == 0


@pytest.mark.parametrize("verb", [[], ["fleet"], ["serve"]])
def test_cli_runs_on_the_card_unless_told_otherwise(monkeypatch, verb):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(verb + ["--n-pool", "8", "--quiet"])


def test_cli_sigkill_resume_cache_rerun_and_events(tmp_path):
    """The CLI (``--device cpu``) SIGKILLed after an early checkpoint and
    resumed ends where the uninterrupted run ends, bit for bit; a re-run on
    the filled cache dispatches nothing; the event log (two generations)
    renders through both packages' trace builders."""
    args = ["--n-pool", "48", "--T", "4", "--q", "2", "--executor",
            "thread", "--n", "8", "--b", "6", "--gp-steps", "12",
            "--device", "cpu", "--checkpoint-dir", str(tmp_path / "ckpt"),
            "--cache-dir", str(tmp_path / "cache"), "--events",
            str(tmp_path / "ev.jsonl"), "--quiet"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.service.cli"]
    dead = subprocess.run(cmd + args + ["--kill-after", "2", "--out",
                                        str(tmp_path / "dead.json")],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert dead.returncode == -signal.SIGKILL, dead.stderr
    assert not (tmp_path / "dead.json").exists()
    out = tmp_path / "res.json"
    subprocess.run(cmd + args + ["--resume", "--out", str(out)], env=env,
                   check=True, timeout=300)
    got = json.loads(out.read_text())

    space, pool = cli._pool(48, 0, "cpu")
    kw = dict(T=4, q=2, executor="thread", n=8, b=6, gp_steps=12,
              device="cpu")
    want = service_tuner(space, pool, VLSIFlow(space, device="cpu"), **kw)
    assert got["evaluated_rows"] == want.evaluated_rows.tolist()
    assert got["y"] == np.asarray(want.y, np.float64).tolist()
    assert _strip(got["history"]) == _strip(want.history)

    rerun = service_tuner(space, pool, VLSIFlow(space, device="cpu"),
                          cache_dir=str(tmp_path / "cache"), **kw)
    assert rerun.evaluated_rows.tolist() == got["evaluated_rows"]
    svc = rerun.engine_stats["service"]
    assert svc["pool_dispatched"] == 0 and svc["disk"]["misses"] == 0

    ev = str(tmp_path / "ev.jsonl")
    assert {r["gen"] for r in obs.read_events(ev)} == {0, 1}
    trace = obs.build_chrome_trace(ev)
    assert trace == obs_j.build_chrome_trace(ev)
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"round", "checkpoint", "generation"} <= names
    assert any(e["ph"] == "b" for e in trace["traceEvents"])
