"""``constraint`` and the sharded LM program on a 4-rank CPU mesh.

``constraint`` is the identity without a mesh and on plain tensors, and a
DTensor redistribution to the resolved spec under one. The sharded program
(parameters, batch and train state as DTensors on a (2, 2) data x model
mesh over gloo, four processes: this file run as a script is one rank) is
held against the unsharded port on the same inputs:
``mistral-nemo-12b@smoke`` head-parallel, the same with sequence
parallelism forced (heads unsharded, q split on its sequence, so each
rank's queries meet every key at their own positions) and two microbatches,
that case once more with ``attention=flash_attention`` (K5's plain version
on the CPU: the dispatch a CUDA rank takes, each query shard at its
``q_offset``) against the unsharded ``_sdpa`` run,
``deepseek-v2-lite-16b@smoke`` (MLA, MoE with expert-parallel slabs) and
``mamba2-370m@smoke`` (the SSD on each rank's batch and head shards):
prefill logits, a decode step's logits after it (over a cache sharded on
its slots where the KV heads do not shard: the flash-decoding combine),
a train step's loss and its first moments m (= 0.1 x the clipped
gradient, leaf by leaf). The sharded program's matmuls sum their
bf16 partial products in another order, so the tolerances are those of
the port's other bf16 comparisons (``TOL``). For the same reason a near-
tie of the router may pick another expert (one choice of layer 1 flips
under the step's tensor-parallel compute copy), so the sharded runs replay
the unsharded runs' expert choices layer by layer (``routing=``), as the
port's card-vs-CPU MoE checks do.

The sharded program is also held against the reference's own sharded
program: ``mistral-nemo-12b@smoke`` and ``deepseek-v2-lite-16b@smoke``
from the reference's ``init`` (through ``convert.lm_params_from_numpy``),
prefill logits and the loss with the reference's constraints on a (2, 2)
mesh of 4 forced CPU host devices (a subprocess) against the port's on the
4-rank mesh, at ``tests/test_torch_lm.py``'s logits tolerances and this
file's loss tolerance, with no choices replayed.
"""
import copy
import json
import os
import pickle
import socket
import subprocess
import sys
import textwrap
import time

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.parallel.sharding import (Mesh, P, axis_rules, constraint,
                                           placements)

#: case -> (arch at smoke size, rule overrides, microbatches, the sharded
#: runs' attention: None for the CPU's ``_sdpa``, or "k5" for K5's
#: ``flash_attention``, whose plain version runs here)
SEQ_PARALLEL = {"heads": (), "kv_heads": ()}
CASES = {
    "dense": ("mistral-nemo-12b", None, 0, None),
    "dense_seq_parallel": ("mistral-nemo-12b", SEQ_PARALLEL, 2, None),
    "dense_seq_parallel_k5": ("mistral-nemo-12b", SEQ_PARALLEL, 2, "k5"),
    "moe_mla": ("deepseek-v2-lite-16b", None, 0, None),
    "ssm": ("mamba2-370m", None, 0, None),
}
#: (max, mean) relative error of the prefill logits and of each leaf of m
#: (relative to the leaf's largest entry), and the loss's absolute error:
#: the bf16 tolerances of the port's card-vs-CPU gradient checks
TOL = {"logits": (2 ** -4, 2 ** -5), "m": (2 ** -4, 2 ** -5), "loss": 5e-3}
WORLD = 4
#: the archs held against the reference's sharded program, and its
#: tolerances: tests/test_torch_lm.py's ATOL / MEAN_TOL on the logits
#: (absolute); TOL's on the loss (the reference's own sharded and
#: one-device losses part by ~1.3e-3 at mistral-nemo-12b@smoke: its bf16
#: partial sums run in another order too)
REFERENCE_ARCHS = ("mistral-nemo-12b", "deepseek-v2-lite-16b")
REF_TOL = {"logits": (0.0625, 0.01), "loss": TOL["loss"]}

#: the reference's side: each arch's smoke params from its ``init``, the
#: bf16 cast of every matrix placed at its spec on a (2, 2) data x model
#: mesh of 4 host devices, the prefill's last logits and the loss jitted
#: under ``axis_rules`` (its constraints in force), and the loss jitted
#: on one device without them; pickled with the float32 params and the
#: tokens
_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.models import init, loss_fn, prefill
    from repro.parallel.sharding import axis_rules
    assert jax.device_count() == 4, jax.devices()
    out_path, archs = sys.argv[1], sys.argv[2:]
    is_axes = lambda t: isinstance(t, tuple) and all(
        a is None or isinstance(a, str) for a in t)
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2), ("data", "model"))
    out = {}
    for i, arch in enumerate(archs):
        cfg = get_config(arch, smoke=True)
        params, axes = init(cfg, jax.random.PRNGKey(7 + i))
        tokens = np.random.default_rng(4 + i).integers(
            0, cfg.vocab, (4, 17)).astype(np.int32)
        with mesh, axis_rules(mesh) as r:
            p = jax.tree.map(
                lambda ax, a: jax.device_put(
                    a.astype(jnp.bfloat16) if a.ndim > 1 else a,
                    r.sharding(ax, a.shape)), axes, params, is_leaf=is_axes)
            put = lambda t: jax.device_put(t, r.sharding(("batch", None),
                                                         t.shape))
            logits = jax.jit(lambda p, t: prefill(p, cfg, {"tokens": t})[1])(
                p, put(tokens[:, :16]))
            loss = jax.jit(lambda p, t: loss_fn(p, cfg, {"tokens": t})[0])(
                p, put(tokens))
        one = jax.tree.map(lambda a: jnp.asarray(
            a.astype(jnp.bfloat16) if a.ndim > 1 else a), params)
        loss_one = jax.jit(lambda p, t: loss_fn(p, cfg, {"tokens": t})[0])(
            one, tokens)
        out[arch] = dict(params=jax.tree.map(np.asarray, params),
                         tokens=tokens, loss=float(loss),
                         loss_one_device=float(loss_one),
                         logits=np.asarray(logits.astype(jnp.float32)))
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".tmp", out_path)
""")


def test_constraint_is_identity_without_a_mesh():
    x = torch.randn(4, 8, 16)
    assert constraint(x, "batch", "seq", None) is x
    mesh = Mesh(np.full((2, 2), "cpu", dtype=object), ("data", "model"))
    with axis_rules(mesh):  # a plain tensor under a mesh: itself too
        assert constraint(x, "batch", "seq", None) is x


def test_placements_follow_the_mesh_order():
    """An entry naming two mesh axes shards its dim over both, the first
    the major one (JAX's order, DTensor's left to right); another order
    is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = Mesh(np.full((2, 2, 2), "cpu", dtype=object),
                ("pod", "data", "model"))
    assert placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements(P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError):
        placements(P(("data", "pod")), mesh)


def test_remat_recompute_keeps_the_rules_on_another_thread():
    """Autograd runs a CUDA backward, remat's recompute included, on a
    thread of its own, which entered no axis rules: the recompute enters
    the forward's rules again there (``remat_contexts``). On a one-rank
    (1, 1) mesh every placement is ``Replicate``, so the sharded loss and
    gradients, the backward run on another thread, equal the unsharded
    port's bit for bit."""
    import threading

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models.model import init, loss_fn, param_axes
    from repro_torch.parallel.sharding import distribute

    cfg = get_config("mistral-nemo-12b", smoke=True)
    tokens = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 17)), dtype=torch.int64)
    model = init(cfg, torch.Generator().manual_seed(0), "cpu")
    model.requires_grad_(True)
    loss, _ = loss_fn(model, {"tokens": tokens}, remat=True)
    want = torch.autograd.grad(loss, list(model.parameters()))

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = Mesh(np.full((1, 1), "cpu", dtype=object), ("data", "model"))
        with axis_rules(mesh) as r:
            axes = param_axes(cfg, model)
            for name, p in list(model.named_parameters()):
                mod_name, _, leaf = name.rpartition(".")
                mod = model.get_submodule(mod_name) if mod_name else model
                setattr(mod, leaf, torch.nn.Parameter(
                    distribute(p.data, axes[name], r)))
            sloss, _ = loss_fn(model, {"tokens": distribute(
                tokens, ("batch", None), r)}, remat=True)
            got = []

            def backward():  # a thread that entered no axis rules
                with implicit_replication():  # as the step's backward
                    got.extend(torch.autograd.grad(
                        sloss, list(model.parameters())))

            t = threading.Thread(target=backward)
            t.start()
            t.join()
        assert torch.equal(sloss.full_tensor(), loss)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g.full_tensor(), w)
    finally:
        dist.destroy_process_group()


def _rel(a, b):
    a, b = a.float(), b.float()
    scale = b.abs().max().clamp(min=1e-30)
    d = (a - b).abs() / scale
    return float(d.max()), float(d.mean())


def _case(arch, rules, micro, attention):
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import flash_attention
    from repro_torch.launch.specs import _rebuild_cache
    from repro_torch.models.model import (cache_axes, cache_leaves,
                                          decode_step, init, init_cache,
                                          param_axes, prefill)
    from repro_torch.models.moe import route
    from repro_torch.parallel.sharding import distribute
    from repro_torch.train import (TrainConfig, TrainState, adamw_init,
                                   init_params, make_train_step,
                                   tree_zero1_specs)
    cfg = get_config(arch, smoke=True)
    mesh = Mesh(np.full((2, 2), "cpu", dtype=object), ("data", "model"))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 17)), dtype=torch.int64)
    out = {}
    offsets = set()  # the query offsets K5 took on this rank

    def k5(q, k, v, **kw):
        offsets.add(kw.get("q_offset"))
        return flash_attention(q, k, v, **kw)

    attention = {None: None, "k5": k5}[attention]

    choices = {}

    def record(layer, probs, k):
        return choices.setdefault(layer, route(probs, k))

    def replay(layer, probs, k):
        return choices[layer]

    decode_choices = {}

    def record_decode(layer, probs, k):
        return decode_choices.setdefault(layer, route(probs, k))

    def replay_decode(layer, probs, k):
        return decode_choices[layer]

    model = init(cfg, torch.Generator().manual_seed(0), "cpu")
    pre, ref = prefill(model, tokens[:, :16], routing=record)
    cache = init_cache(cfg, 4, 24, device="cpu")
    for k, t in cache_leaves(cache).items():
        t[:, :, :16] = cache_leaves(pre)[k]
    step_tok = tokens[:, 16]
    _, ref_dec = decode_step(model, copy.deepcopy(cache), step_tok, 16,
                             routing=record_decode)
    with axis_rules(mesh, rules) as r:
        sm = copy.deepcopy(model)
        axes = param_axes(cfg, sm)
        for name, p in list(sm.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = sm.get_submodule(mod_name) if mod_name else sm
            setattr(mod, leaf, torch.nn.Parameter(
                distribute(p.data, axes[name], r), requires_grad=False))
        _, got = prefill(sm, distribute(tokens[:, :16], ("batch", None), r),
                         routing=replay, attention=attention)
        out["logits"] = _rel(got.full_tensor(), ref)
        c_axes = cache_axes(cfg)
        scache = _rebuild_cache(cache, {
            k: distribute(t, c_axes[k], r)
            for k, t in cache_leaves(cache).items()})
        out["cache_seq_sharded"] = any(
            p.is_shard(2) for t in cache_leaves(scache).values()
            for p in t.placements)
        _, dec = decode_step(sm, scache, distribute(step_tok, ("batch",), r),
                             16, routing=replay_decode)
        out["decode"] = _rel(dec.full_tensor(), ref_dec)

    masters = init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    tcfg = TrainConfig(microbatch=micro)
    choices.clear()
    step = make_train_step(cfg, tcfg, "cpu", routing=record)
    st, _, met = step(adamw_init({k: v.clone() for k, v in masters.items()}),
                      {"tokens": tokens}, None)
    with axis_rules(mesh, rules) as r:
        sstep = make_train_step(cfg, tcfg, "cpu", routing=replay,
                                attention=attention)
        zs = tree_zero1_specs(param_axes(cfg, sstep.model), masters, r)

        def dist(t, k):
            return distribute(t, None, r, spec=zs[k])

        state = TrainState(
            torch.zeros((), dtype=torch.int32),
            {k: dist(v.clone(), k) for k, v in masters.items()},
            {k: dist(torch.zeros_like(v), k) for k, v in masters.items()},
            {k: dist(torch.zeros_like(v), k) for k, v in masters.items()})
        sst, _, smet = sstep(state, {"tokens": distribute(
            tokens, ("batch", None), r)}, None)
        out["sharded_leaves"] = sum(
            any(p.is_shard() for p in t.placements) for t in sst.m.values())
        out["loss"] = abs(float(smet["loss"]) - float(met["loss"]))
        errs = {k: _rel(sst.m[k].full_tensor(), st.m[k]) for k in st.m}
    ranks = [None] * WORLD
    torch.distributed.all_gather_object(ranks, sorted(offsets, key=str))
    out["q_offsets"] = ranks
    out["m_max"] = max(e[0] for e in errs.values())
    out["m_mean"] = max(e[1] for e in errs.values())
    out["m_worst"] = max(errs, key=lambda k: errs[k][0])
    out["n_leaves"] = len(errs)
    return out


def _reference_case(arch: str, ref: dict) -> dict:
    """The port's sharded prefill logits and loss of the reference's
    params and tokens, against the reference's sharded program's."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models.model import loss_fn, param_axes, prefill
    from repro_torch.parallel.sharding import distribute
    cfg = get_config(arch, smoke=True)
    model = lm_params_from_numpy(cfg, ref["params"], "cpu")
    tokens = torch.as_tensor(ref["tokens"], dtype=torch.int64)
    mesh = Mesh(np.full((2, 2), "cpu", dtype=object), ("data", "model"))
    with axis_rules(mesh) as r, torch.no_grad():
        axes = param_axes(cfg, model)
        for name, p in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            setattr(mod, leaf, torch.nn.Parameter(
                distribute(p.data, axes[name], r), requires_grad=False))
        _, logits = prefill(model, distribute(tokens[:, :16],
                                              ("batch", None), r))
        loss, _ = loss_fn(model, {"tokens": distribute(tokens,
                                                       ("batch", None), r)})
        d = (logits.full_tensor().float()
             - torch.from_numpy(ref["logits"])).abs()
        return {"logits": (float(d.max()), float(d.mean())),
                "loss": abs(float(loss.full_tensor()) - ref["loss"]),
                "reference_spread": abs(ref["loss"] - ref["loss_one_device"])}


def _wait_for(path: str, timeout: float = 280.0) -> None:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"no reference results at {path}")
        time.sleep(0.5)


def _worker(rank: int, port: int, path: str, ref_path: str) -> None:
    import datetime

    import torch.distributed as dist
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=300))
    try:
        res = {name: _case(*case) for name, case in CASES.items()}
        _wait_for(ref_path)
        with open(ref_path, "rb") as f:
            refs = pickle.load(f)
        res["reference"] = {arch: _reference_case(arch, refs[arch])
                            for arch in REFERENCE_ARCHS}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(path, "w") as f:
            json.dump(res, f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    path, ref_path = str(tmp / "res.json"), str(tmp / "reference.pkl")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                       [src] + env.get("PYTHONPATH", "").split(os.pathsep)))
    ref_log = tmp / "reference.err"
    with open(ref_log, "w") as err:  # a file: a pipe could fill and block
        reference = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, ref_path, *REFERENCE_ARCHS],
            env=ref_env, stdout=subprocess.DEVNULL, stderr=err)
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port),
                               path, ref_path], env=env)
             for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=300) for p in procs]
        reference.wait(timeout=60)
    finally:
        for p in procs + [reference]:
            if p.poll() is None:
                p.kill()
    assert reference.returncode == 0, ref_log.read_text()[-4000:]
    assert codes == [0] * WORLD, codes
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_program_matches_unsharded(results, case):
    r = results[case]
    assert r["sharded_leaves"] > 0  # the state really is sharded
    if CASES[case][3]:  # K5 took each rank's query shard at its offset
        assert r["q_offsets"] == [[0], [8], [0], [8]], r["q_offsets"]
    for what in ("logits", "decode"):
        assert r[what][0] <= TOL["logits"][0], (what, r)
        assert r[what][1] <= TOL["logits"][1], (what, r)
    assert r["loss"] <= TOL["loss"], r
    assert r["m_max"] <= TOL["m"][0], r
    assert r["m_mean"] <= TOL["m"][1], r


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_sharded_program_matches_reference_sharded(results, arch):
    """The port's sharded logits and loss against the reference's sharded
    program's (printed with ``-rP``, beside the reference's own sharded
    against one-device loss difference, which the loss tolerance must
    cover)."""
    r = results["reference"][arch]
    print(arch, r)
    assert r["reference_spread"] <= REF_TOL["loss"], r
    assert r["logits"][0] <= REF_TOL["logits"][0], r
    assert r["logits"][1] <= REF_TOL["logits"][1], r
    assert r["loss"] <= REF_TOL["loss"], r


if __name__ == "__main__":
    torch.set_num_threads(1)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
