"""MoE serving on the CPU: the port against the live JAX package at the two
MoE smoke configs, ``phi3.5-moe-42b-a6.6b@smoke`` (GQA, 4 experts, top-2)
and ``deepseek-v2-lite-16b@smoke`` (MLA, a dense lead layer, 4 experts,
top-2, one shared expert).

- ``moe_apply`` in float32 (x float32, so the reference runs float32
  throughout) at capacity factors 8.0 (no drops) and 0.5 (drops), B 3 (the
  reference's cross-row slot offsets): outputs at rtol = atol = 1e-5 (two
  frameworks' float32 sums in another order), the expert choices, capacity
  slots, drops and slot table exactly, the aux loss at 1e-6.
- The inputs of one layer are scaled by 0.2 so that its outputs are O(1):
  with unit inputs the smoke experts (fan-in init over E = 4, as
  ``moe_init`` draws them) reach ~170, where float32 sums in another order
  differ by ~2e-5 absolute and one bf16 ulp is 1.0.
- Exact ties (duplicated router columns) go to the lower expert index, as
  ``jax.lax.top_k`` sends them.
- ``moe_apply`` in bf16 at ``tests/test_torch_lm.py``'s ``ATOL`` / ``MEAN_TOL``
  and for its reasons (values may flip by a bf16 ulp; O(1) outputs like
  the logits those tolerances were set for), and bit for bit against the
  reference run op by op (``jax.disable_jit``) at unit inputs with drops.
  Jitted, XLA fuses the router's softmax and computes it with other float32
  roundings (every probability moves by ulps, ~30 % of the bf16 gates by
  one), so the jitted reference is held at the tolerances only.
- The whole smoke models through ``convert.lm_params_from_numpy``: prefill
  logits, the stacked caches (the reference's ``lead_0`` then ``layers``)
  and teacher-forced decode logits against the jitted reference;
  phi3.5@smoke also at capacity factor 0.5, where its decode steps (T = B =
  3, C = 2) drop assignments. The random experts' outputs (~100) dominate
  the residual stream, so the jitted reference's gate flips reach the
  logits: phi3.5@smoke's largest mean difference is 0.0097 here (deepseek
  0.0072); against the reference run op by op it is 0.0028.

Inputs are made with numpy from a seed.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import init as jinit
from repro.models import init_cache as jinit_cache
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import LM, check_ported, decode_step, init_cache, \
    prefill
from repro_torch.models import moe as tmoe
from repro_torch.serve import Engine, ServeConfig

ATOL = 0.0625
MEAN_TOL = 0.01
ARCHS = ["phi3.5-moe-42b-a6.6b@smoke", "deepseek-v2-lite-16b@smoke"]
B, S0, STEPS = 3, 24, 5


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= ATOL, diff.max()
    assert diff.mean() <= MEAN_TOL, diff.mean()


def _configs(arch, cf=None):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    return jcfg, cfg


def _layer(jcfg, cfg, seed=3, tie=None):
    """One ``moe_init`` tree rounded to bf16 (as the port stores it), in
    both packages; ``tie`` (a, b) copies router column a onto column b."""
    p, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32), p)
    if tie is not None:
        a, b = tie
        p["router"] = p["router"].at[:, b].set(p["router"][:, a])
    layer = tmoe.MoE(cfg, "cpu")
    with torch.no_grad():
        for name, w in layer.named_parameters():
            sub = p
            for key in name.split("."):
                sub = sub[key]
            w.copy_(torch.from_numpy(np.array(sub, np.float32)))
    return p, layer


def _reference_routing(p, jcfg, x):
    """The reference's expert choices and capacity slots for ``x``, by its
    own steps (``repro/models/moe.py``: top_k of the float32 softmax, the
    per-row cumsum plus cross-row offsets)."""
    Bx, Sx, d = x.shape
    E, k = jcfg.n_experts, jcfg.top_k
    xt = x.reshape(-1, d)
    probs = jax.nn.softmax((xt @ p["router"].astype(x.dtype))
                           .astype(jnp.float32), axis=-1)
    _, eidx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(eidx.reshape(Bx, Sx * k), E, dtype=jnp.int32)
    within = jnp.cumsum(onehot, axis=1) - onehot
    totals = jnp.sum(onehot, axis=1)
    offsets = jnp.cumsum(totals, axis=0) - totals
    pos = (within + offsets[:, None, :]).reshape(-1, E)
    e_flat = eidx.reshape(-1)
    slot = jnp.take_along_axis(pos, e_flat[:, None], axis=1)[:, 0]
    return np.asarray(eidx), np.asarray(slot)


def _x(shape, seed):
    return 0.2 * np.random.default_rng(seed).normal(size=shape).astype(
        np.float32)


def _recorder(store):
    def routing(probs, k):
        e = tmoe.route(probs, k)
        store.append(e)
        return e
    return routing


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_float32_matches_reference(arch, cf):
    jcfg, cfg = _configs(arch, cf)
    p, layer = _layer(jcfg, cfg)
    x = _x((B, 17, cfg.d_model), len(arch))
    yj, aux_j = jax.jit(jmoe.moe_apply, static_argnums=1)(p, jcfg,
                                                         jnp.asarray(x))
    seen = []
    yt, aux_t = tmoe.moe_apply(layer, cfg, torch.as_tensor(x),
                               routing=_recorder(seen))
    assert yt.dtype == torch.float32 and aux_t.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)

    eidx_j, slot_j = _reference_routing(p, jcfg, jnp.asarray(x))
    T, E, k = B * 17, cfg.n_experts, cfg.top_k
    C = tmoe.capacity(T, k, E, cf)
    assert C == int(min(max(k, round(T * k / E * cf)), T))
    np.testing.assert_array_equal(seen[0].numpy(), eidx_j)
    slot_t = tmoe.arrival_slots(seen[0].reshape(-1), E)
    np.testing.assert_array_equal(slot_t.numpy(), slot_j)
    keep_j = slot_j < C
    assert (cf == 8.0) == bool(keep_j.all())  # 0.5 drops, 8.0 does not
    e_flat = seen[0].reshape(-1)
    tok = torch.arange(T).repeat_interleave(k)
    keep_t = slot_t < C
    slots_t = tmoe._scatter_slots(e_flat, slot_t, keep_t, tok, E, C, T)
    slots_j = jmoe._scatter_slots(jnp.asarray(eidx_j.reshape(-1)),
                                  jnp.asarray(slot_j), jnp.asarray(keep_j),
                                  jnp.repeat(jnp.arange(T), k), E, C, T)
    np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))


def test_ties_go_to_the_lower_expert_as_top_k_sends_them():
    """Router columns 1 and 3 copied from columns 0 and 2: every token's
    probabilities tie in pairs, and the lower index must come first."""
    jcfg, cfg = _configs("deepseek-v2-lite-16b@smoke", 0.5)
    p, layer = _layer(jcfg, cfg, seed=4, tie=(0, 1))
    p["router"] = p["router"].at[:, 3].set(p["router"][:, 2])
    with torch.no_grad():
        layer.router.copy_(torch.from_numpy(np.array(p["router"], np.float32)))
    x = _x((B, 9, cfg.d_model), 2)
    seen = []
    yt, _ = tmoe.moe_apply(layer, cfg, torch.as_tensor(x),
                           routing=_recorder(seen))
    eidx_j, _ = _reference_routing(p, jcfg, jnp.asarray(x))
    np.testing.assert_array_equal(seen[0].numpy(), eidx_j)
    assert set(map(tuple, eidx_j.tolist())) <= {(0, 1), (2, 3)}
    yj, _ = jmoe.moe_apply(p, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)

    # ranks of equal values, straight against top_k: small integers tie often
    probs = np.random.default_rng(3).integers(0, 4, (200, 16)).astype(
        np.float32)
    _, want = jax.lax.top_k(jnp.asarray(probs), 6)
    np.testing.assert_array_equal(tmoe.route(torch.as_tensor(probs), 6)
                                  .numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_matches_reference(arch):
    jcfg, cfg = _configs(arch, 0.5)
    p, layer = _layer(jcfg, cfg, seed=5)
    x = _x((B, 17, cfg.d_model), 6)
    pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    yj, _ = jax.jit(jmoe.moe_apply, static_argnums=1)(
        pj, jcfg, jnp.asarray(x, jnp.bfloat16))
    yt, _ = tmoe.moe_apply(layer, cfg, torch.as_tensor(x).bfloat16())
    assert yt.dtype == torch.bfloat16
    _close(yt, yj)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_bf16_equals_the_reference_op_by_op(arch):
    """Unit inputs (outputs ~100), capacity factor 0.5 (drops): the port's
    bf16 output and aux loss equal the reference's, run op by op, bit for
    bit."""
    jcfg, cfg = _configs(arch, 0.5)
    p, layer = _layer(jcfg, cfg, seed=5)
    x = np.random.default_rng(6).normal(
        size=(B, 17, cfg.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p)
    with jax.disable_jit():
        yj, aux_j = jmoe.moe_apply(pj, jcfg, jnp.asarray(x, jnp.bfloat16))
    yt, aux_t = tmoe.moe_apply(layer, cfg, torch.as_tensor(x).bfloat16())
    np.testing.assert_array_equal(yt.float().numpy(),
                                  np.asarray(yj.astype(jnp.float32)))
    assert float(aux_t) == float(aux_j)


def _decode_path(jcfg, params, prefill_out, tokens, step):
    jc, jl = prefill_out
    jdec, _ = jinit_cache(jcfg, B, S0 + STEPS)
    # the stacked layers are [L, B, S, ...], a lead layer's [B, S, ...]
    jdec = {key: jax.tree.map(
        lambda z, c: (z.at[:, :, :S0] if key == "layers" else z.at[:, :S0])
        .set(c), jdec[key], jc[key]) for key in jdec}
    logits = []
    for i in range(STEPS):
        jdec, jl = step(params, jdec, jnp.asarray(tokens[:, i]),
                        jnp.int32(S0 + i))
        logits.append(jl)
    return logits


def _stacked(caches):
    """The reference's caches as one stack of all layers: ``lead_{i}`` (one
    layer each), then ``layers.b0.attn`` ([L, ...] each field)."""
    lead = sorted(k for k in caches if k.startswith("lead_"))
    fields = caches["layers"]["b0"]["attn"]
    return [np.concatenate([np.asarray(caches[k]["attn"][f].astype(
        jnp.float32))[None] for k in lead] + [np.asarray(
            fields[f].astype(jnp.float32))]) for f in range(len(fields))]


@pytest.mark.parametrize("arch,cf", [(ARCHS[0], None), (ARCHS[1], None),
                                     (ARCHS[0], 0.5)],
                         ids=["phi3.5", "deepseek", "phi3.5-cf0.5"])
def test_prefill_cache_and_teacher_forced_decode(arch, cf):
    jcfg, cfg = _configs(arch, cf)
    params, _ = jinit(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    assert [b.moe is not None for b in model.layers] == [
        i >= cfg.first_dense_layers for i in range(cfg.n_layers)]
    if cfg.first_dense_layers:
        assert model.layers[0].mlp.wg.shape == (cfg.d_model, cfg.dense_d_ff)
    toks = np.random.default_rng(len(arch)).integers(
        0, cfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    pre = jax.jit(lambda p, b: jprefill(p, jcfg, b))(
        params, {"tokens": jnp.asarray(toks[:, :S0])})
    step = jax.jit(lambda p, c, t, pos: jdecode_step(p, jcfg, c, t, pos))
    forced = _decode_path(jcfg, params, pre, toks[:, S0:], step)

    tc, tl = prefill(model, torch.as_tensor(toks[:, :S0]))
    _close(tl, pre[1])
    for got, want in zip(tc, _stacked(pre[0])):
        assert tuple(got.shape) == want.shape
        _close(got, want)
    eng = Engine(cfg, model, ServeConfig(max_len=S0 + STEPS))
    dec = eng._merge_caches(init_cache(cfg, B, S0 + STEPS, device="cpu"),
                            tc, S0)
    dropped = 0
    for i in range(STEPS):
        seen = []
        rec = _recorder(seen)
        dec, tl = decode_step(model, dec, torch.as_tensor(toks[:, S0 + i]),
                              S0 + i, routing=lambda layer, probs, k:
                              rec(probs, k))
        _close(tl, forced[i])
        C = tmoe.capacity(B, cfg.top_k, cfg.n_experts, cfg.capacity_factor)
        dropped += sum(int((tmoe.arrival_slots(e.reshape(-1),
                                               cfg.n_experts) >= C).sum())
                       for e in seen)
    assert (dropped > 0) == (cf == 0.5), dropped


def test_moe_configs_build_for_cuda_by_default(monkeypatch):
    """Both MoE configs pass ``check_ported`` for the default device (CUDA)
    at full width; without a card the build then asks for one (it does not
    fall back to the CPU)."""
    for arch in ("deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(arch)
        check_ported(cfg)
        check_ported(cfg, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(get_config(ARCHS[1]))
