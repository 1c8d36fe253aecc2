"""The LM serving path on the CPU: the port against the live JAX package at
the three dense smoke configs (``mistral-nemo-12b@smoke``; ``qwen3-14b@smoke``
with qk-norm; ``starcoder2-3b@smoke`` with a wider MLP).

The reference's ``init`` tree goes through ``convert.lm_params_from_numpy``,
so both packages hold the same bf16 weights. Prompts and teacher-forced
tokens are made with numpy from a seed.

Tolerance: both packages compute in bf16 and round at different places
(XLA may keep fused intermediates in float32; PyTorch rounds each op), so a
value may differ by a bf16 ulp, and such flips carry through the layers (one
layer's attention alone is bit-equal here). Logits and cached K/V here are
at most ~3 in magnitude, where one bf16 ulp is 2^-6 = 0.0156: ``ATOL`` =
0.0625 (four ulps). Their mean magnitude is ~0.7, where an ulp is 2^-8 to
2^-7, and rounding placement can move most values by one: the mean absolute
difference must stay below ``MEAN_TOL`` = 0.01. A real fault (a wrong mask,
head or position) moves values by O(1). Greedy tokens must be equal wherever
the reference's top-2 logit gap exceeds ``2 * ATOL``.
"""
import dataclasses
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
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (LM, decode_step, init, init_cache, prefill)
from repro_torch.models import attention as tattn
from repro_torch.serve import Engine, ServeConfig

ATOL = 0.0625
MEAN_TOL = 0.01
ARCHS = ["mistral-nemo-12b@smoke", "qwen3-14b@smoke", "starcoder2-3b@smoke"]
B, S0, STEPS = 2, 24, 6


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= ATOL, diff.max()
    assert diff.mean() <= MEAN_TOL, diff.mean()


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    jcfg = jget_config(request.param)
    params, _ = jinit(jcfg, jax.random.PRNGKey(1))
    cfg = get_config(request.param)
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    rng = np.random.default_rng(len(request.param))
    toks = rng.integers(0, cfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    return jcfg, params, cfg, model, toks


def test_config_copy_is_equal():
    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert dataclasses.asdict(get_config(arch, smoke)) == \
                dataclasses.asdict(jget_config(arch, smoke))


def test_gqa_apply_prefill_and_decode(setup):
    """The first layer's attention alone: prefill output and its KVCache,
    then a decode step into a cache whose first S0 slots hold them."""
    jcfg, params, cfg, model, toks = setup
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S0, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S0, dtype=np.int32), (B, S0)).copy()
    p0 = jax.tree.map(lambda a: a[0], params["layers"]["b0"]["attn"])
    p0 = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim > 1 else a,
                      p0)
    attn0 = model.layers[0].attn
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.as_tensor(x).to(torch.bfloat16)
    yj, cj = jattn.gqa_apply(p0, jcfg, xj, jnp.asarray(pos), None,
                             jnp.int32(S0))
    yt, ct = tattn.gqa_apply(attn0, cfg, xt, torch.as_tensor(pos), None, S0)
    _close(yt, yj)
    _close(ct.k, cj.k)
    _close(ct.v, cj.v)
    # positions None (the model's prefill) is the prefill at arange(S0)
    yn, cn = tattn.gqa_apply(attn0, cfg, xt, None, None, S0)
    assert torch.equal(yn, yt) and torch.equal(cn.k, ct.k)

    L = S0 + 1
    zj = jnp.zeros((B, L, cfg.n_kv_heads, cfg.head_dim), jnp.bfloat16)
    cache_j = jattn.KVCache(zj.at[:, :S0].set(cj.k), zj.at[:, :S0].set(cj.v))
    cache_t = tattn.init_kv_cache(cfg, B, L, device="cpu")
    cache_t.k[:, :S0] = ct.k
    cache_t.v[:, :S0] = ct.v
    xd = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pd = np.full((B, 1), S0, np.int32)
    yj, cj = jattn.gqa_apply(p0, jcfg, jnp.asarray(xd, jnp.bfloat16),
                             jnp.asarray(pd), cache_j, jnp.int32(S0))
    yt, ct = tattn.gqa_apply(attn0, cfg, torch.as_tensor(xd).to(torch.bfloat16),
                             torch.as_tensor(pd), cache_t, S0)
    _close(yt, yj)
    _close(ct.k, cj.k)
    assert ct.k is cache_t.k  # written in place
    with pytest.raises(ValueError, match="needs its positions"):
        tattn.gqa_apply(attn0, cfg, torch.as_tensor(xd).to(torch.bfloat16),
                        None, cache_t, S0)


def test_prefill_and_teacher_forced_decode(setup):
    jcfg, params, cfg, model, toks = setup
    jc, jl = jprefill(params, jcfg, {"tokens": jnp.asarray(toks[:, :S0])})
    tc, tl = prefill(model, torch.as_tensor(toks[:, :S0]))
    assert tl.shape == (B, cfg.vocab) and tc.k.shape == (
        cfg.n_layers, B, S0, cfg.n_kv_heads, cfg.head_dim)
    _close(tl, jl)
    _close(tc.k, jc["layers"]["b0"]["attn"].k)
    _close(tc.v, jc["layers"]["b0"]["attn"].v)

    L = S0 + STEPS
    jdec, _ = jinit_cache(jcfg, B, L)
    jdec = jax.tree.map(lambda z, c: z.at[:, :, :S0].set(c), jdec, jc)
    tdec = init_cache(cfg, B, L, device="cpu")
    tdec.k[:, :, :S0] = tc.k
    tdec.v[:, :, :S0] = tc.v
    for i in range(STEPS):
        tok = toks[:, S0 + i]
        jdec, jl = jdecode_step(params, jcfg, jdec, jnp.asarray(tok),
                                jnp.int32(S0 + i))
        tdec, tl = decode_step(model, tdec, torch.as_tensor(tok), S0 + i)
        _close(tl, jl)
    _close(tdec.k, jdec["layers"]["b0"]["attn"].k)


def test_generate_tokens_equal_where_the_gap_is_clear(setup):
    """Engine.generate in both packages. The reference's logits along its
    own greedy path give the top-2 gap at each step; a sequence is compared
    up to the first step where the two paths part (on a near tie)."""
    jcfg, params, cfg, model, toks = setup
    prompt = toks[:, :S0]
    want = np.asarray(JEngine(jcfg, params, JServeConfig(max_len=S0 + STEPS))
                      .generate({"tokens": jnp.asarray(prompt)}, STEPS))
    got = Engine(cfg, model, ServeConfig(max_len=S0 + STEPS)).generate(
        torch.as_tensor(prompt), STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    got = got.numpy()

    jc, jl = jprefill(params, jcfg, {"tokens": jnp.asarray(prompt)})
    jdec, _ = jinit_cache(jcfg, B, S0 + STEPS)
    jdec = jax.tree.map(lambda z, c: z.at[:, :, :S0].set(c), jdec, jc)
    same = np.ones(B, bool)  # sequences whose paths have not parted
    checked = 0
    for i in range(STEPS):
        top2 = np.sort(np.asarray(jl.astype(jnp.float32)), axis=-1)[:, -2:]
        clear = same & (top2[:, 1] - top2[:, 0] > 2 * ATOL)
        np.testing.assert_array_equal(got[clear, i], want[clear, i])
        checked += int(clear.sum())
        same &= got[:, i] == want[:, i]
        jdec, jl = jdecode_step(params, jcfg, jdec, jnp.asarray(want[:, i]),
                                jnp.int32(S0 + i))
    assert checked > 0


def test_sampling_draws_from_the_generator():
    cfg = get_config("mistral-nemo-12b@smoke")
    model = init(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(cfg, model, ServeConfig(max_len=16, greedy=False))
    prompt = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    a = eng.generate(prompt, 4, torch.Generator().manual_seed(7))
    b = eng.generate(prompt, 4, torch.Generator().manual_seed(7))
    assert torch.equal(a, b) and int(a.min()) >= 0 and \
        int(a.max()) < cfg.vocab
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(prompt, 9)


def test_init_draws_the_reference_distributions():
    """Dense weights: a standard normal truncated to [-2, 2] times
    1/sqrt(shape[0]) (std 0.8796/sqrt(fan_in)); the embedding a normal times
    1/sqrt(d); norm scales ones. Matrices in bf16, norms in float32; the
    same generator seed gives the same weights."""
    cfg = dataclasses.replace(get_config("mistral-nemo-12b@smoke"),
                              d_model=256, d_ff=512, vocab=1024)
    model = init(cfg, torch.Generator().manual_seed(3), device="cpu")
    again = init(cfg, torch.Generator().manual_seed(3), device="cpu")
    for (name, w), (_, w2) in zip(model.named_parameters(),
                                  again.named_parameters()):
        assert torch.equal(w, w2), name
        assert not w.requires_grad
        assert w.dtype == (torch.bfloat16 if w.dim() > 1 else torch.float32)
    trunc_std = 0.8796
    for w in (model.layers[0].mlp.wg, model.layers[1].attn.wq, model.head):
        wf = w.float() * math.sqrt(w.shape[0])
        assert float(wf.abs().max()) <= 2.0 + 1e-2
        assert abs(float(wf.std()) - trunc_std) < 0.01
    e = model.embed.float() * math.sqrt(cfg.d_model)
    assert abs(float(e.std()) - 1.0) < 0.01
    assert bool((model.final_ln == 1).all() and (model.layers[0].ln1 == 1)
                .all())


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "whisper-tiny", "pixtral-12b"])
def test_unported_families_raise_when_built(arch, monkeypatch):
    """Every family of the registry is ported now: SSM (mamba2-370m),
    hybrid (recurrentgemma-9b), audio (whisper-tiny, an encoder-decoder)
    and vision (pixtral-12b). Each builds on the CPU, with its decode
    cache, and for the default device without a card asks for one instead
    of falling back (``tests/test_torch_ssm.py``, ``test_torch_hybrid.py``,
    ``test_torch_encdec.py``, ``test_torch_vlm.py``). What is still refused
    when built is a family outside the registry
    (``test_check_ported_refuses_a_family_outside_the_registry``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(arch, smoke=True)
    LM(cfg, "cpu")
    init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)


@pytest.mark.parametrize("change", [dict(family="diffusion"),
                                    dict(attn_kind="mla")],
                         ids=["unknown-family", "encdec-mla"])
def test_check_ported_refuses_a_family_outside_the_registry(change):
    """``check_ported`` still refuses what the registry does not hold, on
    the CPU as on the card (the check comes before the device's): a family
    of its own, and an encoder-decoder with MLA attention (the reference's
    MLA takes no ``causal``, so its encoder would be causal)."""
    cfg = dataclasses.replace(get_config("whisper-tiny", smoke=True),
                              **change)
    for device in ("cpu", None):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            LM(cfg, device)
        with pytest.raises(NotImplementedError, match="not yet ported"):
            init_cache(cfg, 1, 8, device=device)


def test_sliding_window_raises_for_cuda_and_runs_on_the_cpu(monkeypatch):
    """A dense config with a window: it builds for CUDA now (K5 takes the
    window; without a card the build asks for one and does not fall back);
    the CPU runs the reference's windowed ``_sdpa`` and matches the JAX
    package; the engine serves it past the window from the ring cache, as
    the reference's engine does (the hybrid's tests hold the ring's logits
    and tokens to the reference)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg = dataclasses.replace(jget_config("mistral-nemo-12b@smoke"),
                               window=8)
    cfg = dataclasses.replace(get_config("mistral-nemo-12b@smoke"), window=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(cfg)
    params, _ = jinit(jcfg, jax.random.PRNGKey(2))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 20))
    _, jl = jprefill(params, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)})
    _, tl = prefill(model, torch.as_tensor(toks))
    _close(tl, jl)
    want = np.asarray(JEngine(jcfg, params, JServeConfig(max_len=24))
                      .generate({"tokens": jnp.asarray(toks, jnp.int32)}, 4))
    got = Engine(cfg, model, ServeConfig(max_len=24)).generate(
        torch.as_tensor(toks), 4).numpy()
    assert got.shape == want.shape == (1, 4)
    assert ((0 <= got) & (got < cfg.vocab)).all()
