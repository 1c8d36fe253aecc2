"""The port's checkpoints (``repro_torch.service.checkpoint``, a copy of the
reference's) and resumable runs (``soc_tuner``'s and ``fleet_tuner``'s
``checkpoint_dir``, ``checkpoint_every`` and ``resume``) on the CPU.

The on-disk format is the reference's: a snapshot one package writes, the
other reads. A run cut at round k and resumed (T may grow) must equal the
uninterrupted run bit for bit: rows, metrics, the ADRS history without its
wall times, the engine's counters and, with the proposer on, the live pool.
"""
import json
import os
import sys

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import numpy as np

from repro.service import checkpoint as ckpt_j
from repro_torch.core import FleetScenario, fleet_tuner, make_space, soc_tuner
from repro_torch.random import GeneratorDraws
from repro_torch.service import checkpoint as ckpt
from repro_torch.soc import VLSIFlow

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_propose import JaxKeyDraws  # noqa: E402

KW = dict(T=5, n=10, b=6, gp_steps=20)
CUT = 2


@pytest.fixture(scope="module")
def pool96():
    space = make_space()
    return space.sample(torch.Generator().manual_seed(7), 96).numpy()


def _tree():
    rng = np.random.default_rng(0)
    return {"driver": "soc_tuner", "round": 3, "x": rng.normal(size=(4, 3)),
            "f32": rng.normal(size=(5,)).astype(np.float32),
            "ints": np.arange(6, dtype=np.int64),
            "nested": {"a": [1, 2.5, None, "s"], "b": {"c": np.ones((2, 2))}},
            "history": [{"round": 0, "adrs": 0.1234567890123}],
            "scalar": np.float32(1.5)}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)  # bitwise for floats
    elif isinstance(a, np.generic):
        assert a.item() == b
    else:
        assert a == b


# ------------------------------------------------------------ the format
def test_snapshot_roundtrip_version_atomic_and_pruned(tmp_path):
    tree = _tree()
    path = ckpt.save_snapshot(ckpt.snapshot_path(str(tmp_path), 3), tree)
    assert os.path.basename(path) == "ckpt_000003.npz"
    _assert_tree_equal(tree, ckpt.load_snapshot(path))
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    with np.load(path) as z:  # a file of another version is refused
        payload = {k: z[k] for k in z.files}
    skel = json.loads(str(payload["__tree__"]))
    assert skel["__version__"] == ckpt.SNAPSHOT_VERSION == 1
    skel["__version__"] = 2
    payload["__tree__"] = np.asarray(json.dumps(skel))
    bad = tmp_path / "ckpt_000009.npz"
    np.savez(bad, **payload)
    for mod in (ckpt, ckpt_j):
        with pytest.raises(ValueError, match="snapshot version 2"):
            mod.load_snapshot(str(bad))
    os.unlink(bad)
    for r in (1, 2, 4, 5, 7):
        ckpt.save_snapshot(ckpt.snapshot_path(str(tmp_path), r), {"r": r})
    ckpt.prune_snapshots(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_000004.npz", "ckpt_000005.npz", "ckpt_000007.npz"]
    assert ckpt.latest_snapshot(str(tmp_path)).endswith("ckpt_000007.npz")
    with pytest.raises(ValueError, match="keep"):
        ckpt.prune_snapshots(str(tmp_path), keep=0)
    with pytest.raises(ValueError, match="without '/'"):
        ckpt.save_snapshot(str(tmp_path / "x.npz"), {"a/b": 1})


def test_one_format_on_disk_for_both_packages(tmp_path, pool96):
    """The reference reads what the port writes (a whole soc_tuner snapshot
    with the proposer's live pool) and the port reads what it writes."""
    space = make_space()
    d = str(tmp_path / "run")
    soc_tuner(space, pool96, VLSIFlow(space, "resnet50", device="cpu"),
              checkpoint_dir=d, incremental=True, proposer=True, seed=1,
              device="cpu", **dict(KW, T=2))
    path = ckpt.latest_snapshot(d)
    ours, theirs = ckpt.load_snapshot(path), ckpt_j.load_snapshot(path)
    _assert_tree_equal(ours, theirs)
    assert ours["driver"] == "soc_tuner" and ours["round"] == 2
    assert ours["engine"]["kind"] == "BOEngine"
    assert ours["pool_live"].shape == pool96.shape
    assert set(ours["draws"]) == {"gen", "prop_gen"}
    tree = _tree()
    p2 = ckpt_j.save_snapshot(str(tmp_path / "ckpt_000001.npz"), tree)
    _assert_tree_equal(ckpt.load_snapshot(p2), ckpt_j.load_snapshot(p2))


# ---------------------------------------------------------------- resume
def _strip(history):
    return [{k: v for k, v in h.items() if k != "wall_s"} for h in history]


def _assert_same_run(a, b):
    np.testing.assert_array_equal(a.evaluated_rows, b.evaluated_rows)
    np.testing.assert_array_equal(a.y, b.y)
    assert _strip(a.history) == _strip(b.history)
    np.testing.assert_array_equal(a.pareto_rows, b.pareto_rows)
    sa = {k: v for k, v in a.engine_stats.items() if k != "proposer"}
    sb = {k: v for k, v in b.engine_stats.items() if k != "proposer"}
    assert sa == sb
    if "proposer" in a.engine_stats:
        pa, pb = a.engine_stats["proposer"], b.engine_stats["proposer"]
        assert {k: v for k, v in pa.items() if k != "wall_s"} == \
            {k: v for k, v in pb.items() if k != "wall_s"}
        np.testing.assert_array_equal(a.pool_live, b.pool_live)
    else:
        assert a.pool_live is None and b.pool_live is None


SOC_CASES = [dict(incremental=False), dict(incremental=True),
             dict(incremental=True, proposer={"enabled": True,
                                              "n_propose": 3, "scale": 0.3}),
             dict(incremental=True, q=2, pool_chunk=40, proposer=True)]


@pytest.mark.parametrize("extra", SOC_CASES,
                         ids=["exact", "incremental", "proposer",
                              "proposer-q2-chunked"])
def test_soc_tuner_resume_equals_the_uninterrupted_run(tmp_path, pool96,
                                                       extra):
    space = make_space()
    ref = VLSIFlow(space, "resnet50", device="cpu")(pool96)[:8]

    def run(**kw):
        flow = VLSIFlow(space, "resnet50", device="cpu")
        return soc_tuner(space, pool96, flow, seed=2, device="cpu",
                         reference_front=ref, **{**KW, **extra, **kw}), flow

    full, _ = run()
    d = str(tmp_path)
    run(T=CUT, checkpoint_dir=d)
    assert ckpt.latest_snapshot(d).endswith(f"ckpt_{CUT:06d}.npz")
    n_cut = len(ckpt.load_snapshot(ckpt.latest_snapshot(d))["evaluated"])
    resumed, flow = run(checkpoint_dir=d, resume=True)
    _assert_same_run(full, resumed)
    # no flow evaluation of the prologue or of rounds 1..CUT again
    assert flow.evaluated == len(full.evaluated_rows) - n_cut
    if extra.get("proposer"):
        assert full.engine_stats["pool_replacements"] > 0


def test_soc_tuner_resume_with_jax_key_draws_and_every_two(tmp_path, pool96):
    """The draws' state is whatever the draws object keeps: here a JAX key.
    ``checkpoint_every=2`` writes rounds 2 and 4; a resume from round 4
    with a larger T ends where the uninterrupted run does."""
    space = make_space()
    flow = VLSIFlow(space, "resnet50", device="cpu")
    kw = dict(KW, incremental=True, proposer=True, device="cpu")
    full = soc_tuner(space, pool96, flow, T=6,
                     draws=JaxKeyDraws(jax.random.PRNGKey(3)),
                     **{k: v for k, v in kw.items() if k != "T"})
    d = str(tmp_path)
    soc_tuner(space, pool96, flow, draws=JaxKeyDraws(jax.random.PRNGKey(3)),
              checkpoint_dir=d, checkpoint_every=2, **kw)
    assert sorted(os.listdir(d)) == ["ckpt_000002.npz", "ckpt_000004.npz"]
    resumed = soc_tuner(space, pool96, flow, T=6,
                        draws=JaxKeyDraws(jax.random.PRNGKey(99)),
                        checkpoint_dir=d, resume=True,
                        **{k: v for k, v in kw.items() if k != "T"})
    _assert_same_run(full, resumed)


@pytest.mark.parametrize("extra", [dict(incremental=False),
                                   dict(incremental=True, proposer=True)],
                         ids=["exact", "proposer"])
def test_fleet_tuner_resume_equals_the_uninterrupted_run(tmp_path, pool96,
                                                         extra):
    space = make_space()
    scen = [FleetScenario("resnet50", 0), FleetScenario("transformer", 1),
            FleetScenario("mobilenet", 0, weights=(2.0, 1.0, 1.0))]

    def run(**kw):
        return fleet_tuner(space, pool96, scen, device="cpu",
                           **{**KW, **extra, **kw})

    full = run()
    d = str(tmp_path)
    run(T=CUT, checkpoint_dir=d)
    snap = ckpt.load_snapshot(ckpt.latest_snapshot(d))
    assert snap["driver"] == "fleet_tuner" and len(snap["draws"]) == 3
    resumed = run(checkpoint_dir=d, resume=True)
    for a, b in zip(full.results, resumed.results):
        _assert_same_run(a, b)
    if extra.get("proposer"):
        np.testing.assert_array_equal(full.cache.pool_idx,
                                      resumed.cache.pool_idx)
        assert full.results[0].engine_stats["pool_replacements"] > 0


def test_a_changed_config_or_pool_does_not_resume(tmp_path, pool96):
    space = make_space()
    flow = VLSIFlow(space, "resnet50", device="cpu")
    d = str(tmp_path)
    kw = dict(KW, T=1, incremental=True, device="cpu")
    soc_tuner(space, pool96, flow, checkpoint_dir=d, **kw)
    with pytest.raises(ValueError, match="gp_steps=20 conflicts with "
                                         "requested gp_steps=21"):
        soc_tuner(space, pool96, flow, checkpoint_dir=d, resume=True,
                  **dict(kw, gp_steps=21))
    with pytest.raises(ValueError, match="proposer"):
        soc_tuner(space, pool96, flow, checkpoint_dir=d, resume=True,
                  proposer=True, **kw)
    other = pool96.copy()
    other[5, 0] = (other[5, 0] + 1) % 2
    with pytest.raises(ValueError, match="different candidate pool"):
        soc_tuner(space, other, flow, checkpoint_dir=d, resume=True, **kw)
    scen = [FleetScenario("resnet50", 0)]
    with pytest.raises(ValueError, match="'soc_tuner' snapshot, not a "
                                         "'fleet_tuner'"):
        fleet_tuner(space, pool96, scen, checkpoint_dir=d, resume=True, **kw)
    fd = str(tmp_path / "fleet")
    fleet_tuner(space, pool96, scen, checkpoint_dir=fd, **kw)
    with pytest.raises(ValueError, match="scenario_params"):
        fleet_tuner(space, pool96, [FleetScenario("resnet50", 1)],
                    checkpoint_dir=fd, resume=True, **kw)
    # resume without a snapshot is a fresh start
    fresh = soc_tuner(space, pool96, flow, checkpoint_dir=str(tmp_path / "e"),
                      resume=True, **kw)
    assert fresh.engine_stats["rounds"] == 1


def test_generator_draws_state_restores_on_their_device():
    draws = GeneratorDraws(3, "cpu")
    draws.round(50, 10, 3, 4)
    state = draws.state_dict()
    again = GeneratorDraws(0, "cpu")
    again.load_state_dict(state)
    a, b = draws.round(50, 10, 3, 4), again.round(50, 10, 3, 4)
    np.testing.assert_array_equal(a[0], b[0])
    assert torch.equal(a[1], b[1])
