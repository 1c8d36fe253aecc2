"""MLA serving on the CPU: the port against the live JAX package at
``minicpm3-4b@smoke`` (q_lora 48, kv_lora 32, nope 16, rope 8, v 16) and
at a ``q_lora = 0`` replace of it (the ``wq`` branch).

The reference's ``init`` tree goes through ``convert.lm_params_from_numpy``
(or a layer's ``mla_init`` tree through the module's ``named_parameters``),
so both packages hold the same bf16 weights; prompts and teacher-forced
tokens are made with numpy from a seed. The reference runs once per module
(the ``ref`` fixture) and each test reads what it needs.

Tolerances are ``tests/test_torch_lm.py``'s and for its reasons: bf16 in
both packages, rounded at different places, so values may flip by a bf16
ulp and carry through the layers; logits and caches are at most ~3 in
magnitude (``ATOL`` 0.0625, four ulps there) and ~0.7 on average
(``MEAN_TOL`` 0.01). The port's absorbed decode is held against the
reference's absorbed decode, never against a prefill (the two forms differ
by up to 0.06 in bf16, ``tests/test_models.py``). K5's plain version is held
against the reference's ``_sdpa`` in float32 at 2e-5 (another summation
order), and the zero-padded q·k dims against the unpadded ones at 1e-6.
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
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attn as K5
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models import attention as tattn
from repro_torch.serve import Engine, ServeConfig

ATOL = 0.0625
MEAN_TOL = 0.01
ARCH = "minicpm3-4b@smoke"
B, S0, STEPS = 2, 24, 6


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= ATOL, diff.max()
    assert diff.mean() <= MEAN_TOL, diff.mean()


def _bf16(tree):
    """A parameter tree as the reference's launcher serves it: matrices in
    bf16, norm scales in float32."""
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim > 1 else a,
                        tree)


def _decode_path(jcfg, params, prefill_out, tokens, step):
    """The reference's decode logits along ``tokens`` [B, STEPS] (one
    ``step`` each) from its prefill, and its final cache."""
    jc, jl = prefill_out
    jdec, _ = jinit_cache(jcfg, B, S0 + STEPS)
    jdec = jax.tree.map(lambda z, c: z.at[:, :, :S0].set(c), jdec, jc)
    logits = [jl]
    for i in range(STEPS):
        jdec, jl = step(params, jdec, jnp.asarray(tokens[:, i]),
                        jnp.int32(S0 + i))
        logits.append(jl)
    return logits, jdec["layers"]["b0"]["attn"]


@pytest.fixture(scope="module")
def ref():
    """The smoke model in both packages, and the reference run once: its
    prefill, the decode logits teacher-forced along the prompt's next
    tokens, and ``Engine.generate`` with the logits along its greedy path
    (``prefill``/``decode_step`` jitted once, as its engine jits them)."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    params, _ = jinit(jcfg, jax.random.PRNGKey(1))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    toks = np.random.default_rng(11).integers(
        0, cfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    pre = jax.jit(lambda p, b: jprefill(p, jcfg, b))(
        params, {"tokens": jnp.asarray(toks[:, :S0])})
    step = jax.jit(lambda p, c, t, pos: jdecode_step(p, jcfg, c, t, pos))
    forced, final = _decode_path(jcfg, params, pre, toks[:, S0:], step)
    gen = np.asarray(JEngine(jcfg, params, JServeConfig(max_len=S0 + STEPS))
                     .generate({"tokens": jnp.asarray(toks[:, :S0])}, STEPS))
    path, _ = _decode_path(jcfg, params, pre, gen, step)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, toks=toks,
                cache=pre[0]["layers"]["b0"]["attn"], logits=pre[1],
                forced=forced[1:], final=final, gen=gen, path=path)


def _layer(jcfg, cfg, q_lora):
    """Layer 0's attention in both packages, for ``q_lora`` (None: the
    config's own) from one ``mla_init`` tree."""
    if q_lora is not None:
        jcfg = dataclasses.replace(jcfg, q_lora=q_lora)
        cfg = dataclasses.replace(cfg, q_lora=q_lora)
    p, _ = jattn.mla_init(jax.random.PRNGKey(7), jcfg)
    layer = tattn.MLAttention(cfg, "cpu")
    with torch.no_grad():
        for name, w in layer.named_parameters():
            w.copy_(torch.from_numpy(np.array(p[name], np.float32)))
    assert {n for n, _ in layer.named_parameters()} == set(p)
    return jcfg, cfg, _bf16(p), layer


@pytest.mark.parametrize("q_lora", [None, 0], ids=["q_lora48", "q_lora0"])
def test_mla_apply_prefill_and_decode(q_lora):
    """One layer: the prefill output and its MLACache (latent, k_rope), then
    an absorbed decode step into a cache whose first S0 slots hold them."""
    jcfg, cfg, p, layer = _layer(jget_config(ARCH), get_config(ARCH), q_lora)
    assert (layer.wq is None) == bool(cfg.q_lora)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S0, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S0, dtype=np.int32), (B, S0)).copy()
    xt = torch.as_tensor(x).to(torch.bfloat16)
    japply = jax.jit(jattn.mla_apply, static_argnums=1)
    yj, cj = japply(p, jcfg, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos),
                    None, jnp.int32(S0))
    yt, ct = tattn.mla_apply(layer, cfg, xt, torch.as_tensor(pos), None, S0)
    _close(yt, yj)
    _close(ct.latent, cj.latent)
    _close(ct.k_rope, cj.k_rope)
    yn, cn = layer(xt, None, None, S0)  # positions None: arange(S0)
    assert torch.equal(yn, yt) and torch.equal(cn.latent, ct.latent)

    L = S0 + 1
    zl = jnp.zeros((B, L, cfg.kv_lora), jnp.bfloat16)
    zr = jnp.zeros((B, L, cfg.qk_rope_dim), jnp.bfloat16)
    cache_j = jattn.MLACache(zl.at[:, :S0].set(cj.latent),
                             zr.at[:, :S0].set(cj.k_rope))
    cache_t = tattn.init_mla_cache(cfg, B, L, device="cpu")
    cache_t.latent[:, :S0] = ct.latent
    cache_t.k_rope[:, :S0] = ct.k_rope
    xd = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    pd = np.full((B, 1), S0, np.int32)
    yj, cj = japply(p, jcfg, jnp.asarray(xd, jnp.bfloat16), jnp.asarray(pd),
                    cache_j, jnp.int32(S0))
    yt, ct = tattn.mla_apply(layer, cfg,
                             torch.as_tensor(xd).to(torch.bfloat16),
                             torch.as_tensor(pd), cache_t, S0)
    _close(yt, yj)
    _close(ct.latent, cj.latent)
    _close(ct.k_rope, cj.k_rope)
    assert ct.latent is cache_t.latent  # written in place


def test_prefill_cache_and_teacher_forced_decode(ref):
    """The whole model: prefill logits and the stacked MLACache, then 6
    teacher-forced absorbed decode steps, against the reference's."""
    cfg, model, toks = ref["cfg"], ref["model"], ref["toks"]
    tc, tl = prefill(model, torch.as_tensor(toks[:, :S0]))
    assert isinstance(tc, tattn.MLACache)
    assert tc.latent.shape == (cfg.n_layers, B, S0, cfg.kv_lora)
    assert tc.k_rope.shape == (cfg.n_layers, B, S0, cfg.qk_rope_dim)
    _close(tl, ref["logits"])
    _close(tc.latent, ref["cache"].latent)
    _close(tc.k_rope, ref["cache"].k_rope)

    eng = Engine(cfg, model, ServeConfig(max_len=S0 + STEPS))
    dec = eng._merge_caches(init_cache(cfg, B, S0 + STEPS, device="cpu"),
                            tc, S0)
    for i in range(STEPS):
        dec, tl = decode_step(model, dec, torch.as_tensor(toks[:, S0 + i]),
                              S0 + i)
        _close(tl, ref["forced"][i])
    _close(dec.latent, ref["final"].latent)
    _close(dec.k_rope, ref["final"].k_rope)


def test_generate_tokens_equal_where_the_gap_is_clear(ref):
    """Engine.generate in both packages; the reference's logits along its
    own greedy path give the top-2 gap at each step, and a sequence is
    compared up to the first step where the two paths part."""
    prompt, want = ref["toks"][:, :S0], ref["gen"]
    got = Engine(ref["cfg"], ref["model"], ServeConfig(
        max_len=S0 + STEPS)).generate(torch.as_tensor(prompt), STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    got = got.numpy()
    same = np.ones(B, bool)
    checked = 0
    for i in range(STEPS):
        top2 = np.sort(np.asarray(ref["path"][i].astype(jnp.float32)),
                       axis=-1)[:, -2:]
        clear = same & (top2[:, 1] - top2[:, 0] > 2 * ATOL)
        np.testing.assert_array_equal(got[clear, i], want[clear, i])
        checked += int(clear.sum())
        same &= got[:, i] == want[:, i]
    assert checked > 0


def _mla_qkv(dqk, dv, S=40, H=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(1, S, H, dqk)).astype(np.float32),
            rng.normal(size=(1, S, H, dqk)).astype(np.float32),
            rng.normal(size=(1, S, H, dv)).astype(np.float32))


@pytest.mark.parametrize("dqk,dv", [(24, 16), (96, 64), (192, 128)])
def test_k5_plain_matches_reference_sdpa_with_unequal_head_dims(dqk, dv):
    """MLA's un-absorbed prefill attention: K5's plain version at scale
    1/√Dqk against the reference's ``_sdpa`` on the same q_cat/k_cat/v
    (minicpm3-4b's smoke and full dims, deepseek-v2-lite's 128 + 64 / 128)."""
    q, k, v = _mla_qkv(dqk, dv, seed=dqk)
    scale = 1.0 / math.sqrt(dqk)
    S = q.shape[1]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (1, S))
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                       qpos=jnp.asarray(pos), kpos=jnp.asarray(pos))
    got = K5.flash_attention_plain(*map(torch.as_tensor, (q, k, v)), scale)
    assert got.shape == (1, S, q.shape[2], dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_zero_padded_qk_dims_equal_the_unpadded_call():
    """The smoke dims 24/16 zero-padded to K5's (32, 16): the same output,
    through the wrapper (which takes (32, 16) and refuses (24, 16))."""
    q, k, v = map(torch.as_tensor, _mla_qkv(24, 16, seed=3))
    scale = 1.0 / math.sqrt(24)
    pad = torch.zeros(q.shape[:3] + (8,))
    want = K5.flash_attention_plain(q, k, v, scale)
    got = K5.flash_attention(torch.cat([q, pad], -1), torch.cat([k, pad], -1),
                             v, scale=scale)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="head dims"):
        K5.flash_attention(q, k, v, scale=scale)


def test_layer_pads_qk_for_k5_and_matches_the_cpu_prefill(ref):
    """An ``attention=`` function stands where K5 runs: the layer hands it
    q and k zero-padded to 32 dims, v contiguous at 16 and the scale
    1/√24; through K5's wrapper (its plain version on the CPU) the logits
    equal the CPU's ``_sdpa`` prefill to float rounding."""
    cfg, model, toks = ref["cfg"], ref["model"], ref["toks"]
    seen = []

    def spy(q, k, v, scale):
        seen.append((q.shape[-1], k.shape[-1], v.shape[-1],
                     v.is_contiguous(), scale))
        return K5.flash_attention(q, k, v, scale=scale)

    prompt = torch.as_tensor(toks[:, :S0])
    cache_k, logits_k = prefill(model, prompt, attention=spy)
    cache_c, logits_c = prefill(model, prompt)
    assert seen == [(32, 32, 16, True, 1.0 / math.sqrt(24))] * cfg.n_layers
    torch.testing.assert_close(logits_k.float(), logits_c.float(), rtol=0,
                               atol=ATOL)
    assert torch.equal(cache_k.latent[0], cache_c.latent[0])
