"""Hybrid serving on the CPU: the port's RG-LRU blocks
(``repro_torch.models.rglru``), the hybrid layer plan and the
sliding-window ring cache against the live JAX package at
``recurrentgemma-9b@smoke`` (3 layers: ``rglru``, ``rglru``, ``attn_mlp``;
d_model 64, 4 query heads on 1 KV head of 16, window 32, lru_width 64).

- ``rglru_apply`` in float32 (x float32, so the reference runs float32
  throughout) at S 45, then one decode step: outputs and the cache's ``h``
  and conv window at rtol = atol = 1e-5. The port's scan (⌈log2 S⌉ passes
  of the reference's ``combine``) multiplies in another order than JAX's
  ``associative_scan`` tree, so h agrees to float32 rounding (the largest
  difference seen is ~5e-7), not bit for bit.
- In bf16, ``gelu`` (JAX's tanh form) equals the reference run op by op
  (``jax.disable_jit``) bit for bit, and a whole ``rglru_apply`` does but
  for at most 0.1 % of its values, each one bf16 ulp away (float32 sums
  and scan products in another order).
- K5's plain version with a window against the reference's ``_sdpa`` in
  float32 at 2e-5, at windows 32 and 5 (a group of 4 query heads a KV head).
- The whole model through ``convert.lm_params_from_numpy``, at prompts of
  28 and 45 (shorter and longer than the window): prefill logits, every
  prefill cache field (the attention layer's K/V, the recurrent layers'
  ``h`` and conv windows), the engine's hand-off to the ring
  (``_merge_caches``) field by field against the reference engine's, and
  teacher-forced decode logits over steps that wrap the ring, then every
  decode cache field, at ``tests/test_torch_lm.py``'s ``ATOL`` /
  ``MEAN_TOL``. The reference is compiled with XLA's excess precision off
  (``_STRICT``), so each of its bf16 steps rounds as its own op-by-op run
  (``jax.disable_jit``) rounds it, bit for bit on these inputs. With the
  default (bf16 intermediates kept in float32 inside a fusion) this
  config's compiled reference differs from its op-by-op run by a mean of
  ~0.011 in the logits (measured over 16 prompts: 0.0099 to 0.0129, max
  up to 0.079), past ``MEAN_TOL``, whatever the port does; the port
  equals the op-by-op run but for bf16 ulp flips (a max of 0.0195 and a
  mean of at most 0.0023 in the logits of those prompts, 0 in half of
  them). Also at 5 layers (a group and a ``tail`` of two ``rglru``
  blocks, the reference's ``tail_{i}``), and ``Engine.generate`` against
  ``repro.serve.Engine`` (its compiled prefill and step the same way).

The reference's parameters are rounded to bf16 where the port stores bf16
(every leaf of more than one dim, as the reference's serving launcher casts
them). Inputs are made with numpy from a seed.
"""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import init as jinit
from repro.models import init_cache as jinit_cache
from repro.models import prefill as jprefill
from repro.models import rglru as jrglru
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attn as K5
from repro_torch.models import (LM, HybridCache, LRUCache, check_ported,
                                decode_step, init_cache, layer_kinds,
                                prefill)
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.models.model import reference_slot
from repro_torch.serve import Engine, ServeConfig

ARCH = "recurrentgemma-9b@smoke"
#: compile the reference without excess precision: every bf16 step rounds
#: to bf16, as in its op-by-op run
_STRICT = dict(compiler_options={"xla_allow_excess_precision": False})
ATOL = 0.0625
MEAN_TOL = 0.01
F32 = dict(rtol=1e-5, atol=1e-5)
B, STEPS = 2, 6


def _close(got: torch.Tensor, want) -> None:
    want = _f32(want)
    got = got.float().numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= ATOL, diff.max()
    assert diff.mean() <= MEAN_TOL, diff.mean()


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _bf16_values(tree):
    """Leaves of more than one dim rounded to bf16 (kept float32)."""
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16).astype(jnp.float32)
                        if a.ndim > 1 else a, tree)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _layer(seed=3):
    """One ``rglru_init`` tree (bf16 values) in both packages, ``lam``
    spread so that the gates differ by channel."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    p, _ = jrglru.rglru_init(jax.random.PRNGKey(seed), jcfg)
    p["lam"] = jnp.asarray(_x((cfg.lru_width,), seed) + 2.0)
    p = _bf16_values(p)
    layer = trglru.RGLRU(cfg, "cpu")
    with torch.no_grad():
        for name, w in layer.named_parameters():
            w.copy_(torch.from_numpy(np.array(p[name], np.float32)))
    return jcfg, cfg, p, layer


def test_rglru_apply_float32_matches_reference():
    jcfg, cfg, p, layer = _layer()
    S = 45
    x = _x((B, S, cfg.d_model), 1)
    yj, cj = jax.jit(lambda p, x: jrglru.rglru_apply(p, jcfg, x, None,
                                                     jnp.int32(S)))(
        p, jnp.asarray(x))
    yt, ct = trglru.rglru_apply(layer, cfg, torch.as_tensor(x), None, S)
    assert isinstance(ct, LRUCache) and ct.h.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), _f32(yj), **F32)
    np.testing.assert_allclose(ct.h.numpy(), _f32(cj.h), **F32)
    np.testing.assert_allclose(ct.conv.numpy(), _f32(cj.conv), **F32)

    xd = _x((B, 1, cfg.d_model), 2)
    yj, cj = jax.jit(lambda p, x, c: jrglru.rglru_apply(p, jcfg, x, c,
                                                        jnp.int32(S)))(
        p, jnp.asarray(xd), cj)
    cache = LRUCache(ct.conv.clone(), ct.h.clone())
    yt, ct2 = trglru.rglru_apply(layer, cfg, torch.as_tensor(xd), cache, S)
    assert ct2.h is cache.h and ct2.conv is cache.conv  # in place
    np.testing.assert_allclose(yt.numpy(), _f32(yj), **F32)
    np.testing.assert_allclose(cache.h.numpy(), _f32(cj.h), **F32)
    np.testing.assert_allclose(cache.conv.numpy(), _f32(cj.conv), **F32)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_scan_is_the_recurrence(S):
    """The log-depth scan against h_t = a_t·h_{t-1} + b_t step by step
    (float64, so only the order of the products differs)."""
    a = torch.as_tensor(np.random.default_rng(S).uniform(
        0, 1, (2, S, 3))).double()
    b = torch.as_tensor(_x((2, S, 3), S)).double()
    h, want = torch.zeros((2, 3), dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(trglru.scan(a, b), torch.stack(want, 1),
                               rtol=1e-12, atol=1e-12)


def _ulp_flips(got: torch.Tensor, want, share: float = 1e-3) -> None:
    """bf16 ``got`` equals ``want`` but for at most ``share`` of its values,
    each one bf16 ulp away: the float32 products inside (the projections,
    the scan) are taken in another order, and a value near a rounding
    boundary may land on the other side."""
    got, want = got.float().numpy(), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    diff = np.abs(got - want)
    assert (diff <= ulp).all(), float((diff / ulp).max())
    assert (diff > 0).mean() <= share, (diff > 0).mean()


def test_bf16_steps_equal_the_reference_op_by_op():
    """``gelu`` in bf16 equals the reference run op by op bit for bit, and
    a whole ``rglru_apply`` (prefill, then a decode step) does but for rare
    one-ulp flips (``_ulp_flips``); its conv window is exact."""
    jcfg, cfg, p, layer = _layer(seed=4)
    x = 3 * _x((B, 9, 64), 5)
    with jax.disable_jit():
        gj = jax.nn.gelu(jnp.asarray(x, jnp.bfloat16))
        pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim > 1
                          else a, p)
        xm = jnp.asarray(_x((B, 9, cfg.d_model), 6), jnp.bfloat16)
        yj, cj = jrglru.rglru_apply(pj, jcfg, xm, None, jnp.int32(9))
        xd = jnp.asarray(_x((B, 1, cfg.d_model), 7), jnp.bfloat16)
        yj1, _ = jrglru.rglru_apply(pj, jcfg, xd, cj, jnp.int32(9))
    # the premise of the model-level tests: the reference compiled with
    # ``_STRICT`` is its op-by-op run
    ys, _ = jax.jit(lambda p, x: jrglru.rglru_apply(p, jcfg, x, None,
                                                    jnp.int32(9)),
                    **_STRICT)(pj, xm)
    np.testing.assert_array_equal(_f32(ys), _f32(yj))
    got = tlayers.gelu(torch.as_tensor(x).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), _f32(gj))
    yt, ct = trglru.rglru_apply(layer, cfg, torch.as_tensor(
        _f32(xm)).bfloat16(), None, 9)
    _ulp_flips(yt, yj)
    np.testing.assert_array_equal(ct.conv.float().numpy(), _f32(cj.conv))
    yt1, _ = trglru.rglru_apply(layer, cfg, torch.as_tensor(
        _f32(xd)).bfloat16(), LRUCache(ct.conv.clone(), ct.h.clone()), 9)
    _ulp_flips(yt1, yj1)


@pytest.mark.parametrize("window", [32, 5])
def test_k5_plain_with_a_window_matches_the_reference_sdpa(window):
    """K5's plain version (as the CPU runs it in place of the kernel) with
    a window, against the reference's ``_sdpa`` with the same mask, float32:
    4 query heads on 1 KV head (h // 4), S 45."""
    S, H, K, hd = 45, 4, 1, 16
    q, k, v = _x((B, S, H, hd), 1), _x((B, S, K, hd), 2), _x((B, S, K, hd), 3)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    want = jattn._sdpa(jnp.asarray(q), jattn._repeat_kv(jnp.asarray(k), H),
                       jattn._repeat_kv(jnp.asarray(v), H), 1 / math.sqrt(hd),
                       qpos=pos, kpos=pos, causal=True, window=window)
    got = K5.flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                   window=window)
    np.testing.assert_allclose(got.numpy(), _f32(want), rtol=2e-5, atol=2e-5)
    before = K5.launches
    on_cpu = K5.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                window=window)
    assert K5.launches == before and torch.equal(on_cpu, got)
    with pytest.raises(ValueError, match="window"):
        K5.flash_attention(*map(torch.as_tensor, (q, k, v)), window=0)


def test_layer_plan_and_reference_slots():
    """recurrentgemma-9b: 12 groups of (rglru, rglru, attn_mlp) and a tail
    of two rglru blocks; block 3g + j reads ``layers.b{j}[g]``, block 36 + i
    ``tail_{i}``."""
    cfg = get_config("recurrentgemma-9b")
    kinds = layer_kinds(cfg)
    assert len(kinds) == 38 and kinds.count("attn_mlp") == 12
    assert kinds[:3] == ["rglru", "rglru", "attn_mlp"] and kinds[36:] == [
        "rglru", "rglru"]
    assert reference_slot(cfg, 5) == ("layers.b2", 1)
    assert reference_slot(cfg, 37) == ("tail_1", None)
    assert layer_kinds(get_config("mamba2-370m")) == ["ssm"] * 48


def _configs(n_layers=None):
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    if n_layers:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return jcfg, cfg


def _ref_fields(cfg, caches) -> list[np.ndarray]:
    """The reference's cache tree as the port's ``HybridCache`` fields
    (attention K, V; recurrent conv, h), each layer of a kind stacked in
    layer order."""
    fields = {"k": [], "v": [], "conv": [], "h": []}
    for i, kind in enumerate(layer_kinds(cfg)):
        path, g = reference_slot(cfg, i)
        sub = caches
        for key in path.split("."):
            sub = sub[key]
        c = sub["lru"] if kind == "rglru" else sub["attn"]
        for name, a in c._asdict().items():
            fields[name].append(_f32(a if g is None else a[g]))
    return [np.stack(fields[n]) for n in ("k", "v", "conv", "h")]


def _fields(c: HybridCache) -> list[torch.Tensor]:
    return [c.attn.k, c.attn.v, c.lru.conv, c.lru.h]


@functools.lru_cache(maxsize=None)
def _model(tail: bool = False):
    """The reference's ``init`` tree (bf16 values), its prefill and decode
    step compiled with ``_STRICT``, and the port's model loaded from the
    tree: the smoke config, or (``tail``) 5 layers whose two ``tail_{i}``
    blocks are the smoke group's recurrent blocks in the other order."""
    if tail:
        jcfg, cfg = _configs(5)
        params = _model()[1]
        params = dict(params, **{
            f"tail_{i}": jax.tree.map(lambda a: a[0],
                                      params["layers"][f"b{1 - i}"])
            for i in range(2)})
    else:
        jcfg, cfg = _configs()
        # compiled: the reference's init run op by op takes ~9 s here
        params = jax.jit(lambda k: jinit(jcfg, k)[0])(jax.random.PRNGKey(1))
        params = _bf16_values(params)
    m = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    pre = jax.jit(lambda p, b: jprefill(p, jcfg, b), **_STRICT)
    step = jax.jit(lambda p, c, t, pos: jdecode_step(p, jcfg, c, t, pos),
                   **_STRICT)
    return jcfg, params, cfg, m, pre, step


@pytest.mark.parametrize("tail,S0", [(False, 28), (False, 45), (True, 45)],
                         ids=["smoke-28", "smoke-45", "5-layers-45"])
def test_prefill_ring_handoff_and_teacher_forced_decode(tail, S0):
    jcfg, params, cfg, m, pre, step = _model(tail)
    toks = np.random.default_rng(S0).integers(
        0, cfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    L = S0 + STEPS                      # the ring: min(L, 32) = 32 slots
    jeng = JEngine(jcfg, params, JServeConfig(max_len=L))
    teng = Engine(cfg, m, ServeConfig(max_len=L))
    jc, jl = pre(params, {"tokens": jnp.asarray(toks[:, :S0])})
    tc, tl = prefill(m, torch.as_tensor(toks[:, :S0]))
    assert isinstance(tc, HybridCache)
    _close(tl, jl)
    for got, want in zip(_fields(tc), _ref_fields(cfg, jc), strict=True):
        assert tuple(got.shape) == want.shape
        _close(got, want)

    jdec, _ = jinit_cache(jcfg, B, L)
    jdec = jeng._merge_caches(jdec, jc, S0)
    tdec = teng._merge_caches(init_cache(cfg, B, L, device="cpu"), tc, S0)
    assert tdec.attn.k.shape[2] == cfg.window
    for got, want in zip(_fields(tdec), _ref_fields(cfg, jdec), strict=True):
        _close(got, want)
    for i in range(STEPS):  # positions S0..L-1: past 31 they wrap the ring
        tok = toks[:, S0 + i]
        jdec, jl = step(params, jdec, jnp.asarray(tok), jnp.int32(S0 + i))
        tdec, tl = decode_step(m, tdec, torch.as_tensor(tok), S0 + i)
        _close(tl, jl)
    for got, want in zip(_fields(tdec), _ref_fields(cfg, jdec), strict=True):
        _close(got, want)


def test_ring_place_keeps_the_last_window_positions():
    """A prefill K/V longer than the ring: position p lands at slot
    p % window, the last ``window`` positions kept; shorter goes first."""
    from repro_torch.serve.engine import _ring_place

    src = torch.arange(45, dtype=torch.float32).reshape(1, 1, 45, 1, 1)
    dst = _ring_place(torch.zeros((1, 1, 32, 1, 1)), src, 32, 45)
    want = [p for p in range(13, 45)]
    assert [int(dst[0, 0, p % 32, 0, 0]) for p in want] == want


def test_generate_tokens_equal_where_the_gap_is_clear():
    """Engine.generate in both packages past the window, compared as
    ``tests/test_torch_lm.py`` compares them (up to the first step where
    the two greedy paths part on a near tie); the reference engine's
    prefill and step compiled with ``_STRICT``."""
    jcfg, params, cfg, m, pre, step = _model()
    S0, steps = 28, STEPS  # the shapes of the decode test's, compiled once
    prompt = np.random.default_rng(8).integers(
        0, cfg.vocab, (B, S0)).astype(np.int32)
    jeng = JEngine(jcfg, params, JServeConfig(max_len=S0 + steps))
    jeng._prefill, jeng._decode = pre, step
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(prompt)}, steps))
    got = Engine(cfg, m, ServeConfig(max_len=S0 + steps)).generate(
        torch.as_tensor(prompt), steps)
    assert got.dtype == torch.int32 and got.shape == (B, steps)
    got = got.numpy()
    jc, jl = pre(params, {"tokens": jnp.asarray(prompt)})
    jdec, _ = jinit_cache(jcfg, B, S0 + steps)
    jdec = jeng._merge_caches(jdec, jc, S0)
    same = np.ones(B, bool)
    checked = 0
    for i in range(steps):
        top2 = np.sort(_f32(jl), axis=-1)[:, -2:]
        clear = same & (top2[:, 1] - top2[:, 0] > 2 * ATOL)
        np.testing.assert_array_equal(got[clear, i], want[clear, i])
        checked += int(clear.sum())
        same &= got[:, i] == want[:, i]
        jdec, jl = step(params, jdec, jnp.asarray(want[:, i]),
                        jnp.int32(S0 + i))
    assert checked > 0


def test_hybrid_configs_build_for_cuda_by_default(monkeypatch):
    """recurrentgemma-9b passes ``check_ported`` for the default device
    (CUDA) at full width, window and all; without a card the build then
    asks for one (it does not fall back to the CPU). The engine takes a
    ring of the whole window past ``max_len`` and refuses a shorter one."""
    cfg = get_config("recurrentgemma-9b")
    check_ported(cfg)
    check_ported(cfg, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(get_config(ARCH))
    small = get_config(ARCH)
    m = LM(small, "cpu")
    m.reset_parameters(torch.Generator().manual_seed(0))
    prompt = torch.zeros((1, 40), dtype=torch.int64)
    assert Engine(small, m, ServeConfig(max_len=32)).generate(
        prompt, 3).shape == (1, 3)
    with pytest.raises(ValueError, match="max_len"):
        Engine(small, m, ServeConfig(max_len=31)).generate(prompt, 3)


@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b"])
def test_audio_and_vision_are_still_refused(arch, monkeypatch):
    """Audio and vision configs were refused until they were ported; now
    they pass ``check_ported`` at full width for the CPU and the default
    device (CUDA), their smoke twins build on the CPU, and without a card
    the default device asks for one (no fallback), as for the hybrid
    above (``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py``)."""
    for device in ("cpu", None, "cuda"):
        check_ported(get_config(arch), device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = get_config(arch, smoke=True)
    assert LM(small, "cpu").cfg is small
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(small)
