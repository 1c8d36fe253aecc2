"""SSM serving on the CPU: the port's Mamba-2 (``repro_torch.models.ssm``)
against the live JAX package at ``mamba2-370m@smoke`` (2 layers, d_model
64, 4 heads of 32, state 16, conv width 4, ssm_chunk 32, tied head).

- ``mamba2_apply`` in float32 (x float32, so the reference runs float32
  throughout) at S a multiple of ``ssm_chunk`` (64), at S not one (45: the
  prefill pads to 64 with dt = 0) and at S < W - 1 (2: the conv window
  keeps a zero row): outputs and the cache's conv window and state at
  rtol = atol = 1e-5 (two frameworks' float32 sums in another order; the
  largest difference seen is ~1e-6), then one decode step from that cache.
- The chunked prefill equals the recurrent form: S decode steps from a
  zeroed cache give the prefill's outputs and final state, in float32.
- In bf16, ``silu`` and ``_conv1d`` equal the reference run op by op
  (``jax.disable_jit``) bit for bit; a whole ``mamba2_apply`` does but for
  at most 0.1 % of its values, each one bf16 ulp away (its projections and
  SSD sums are float32 sums in another order).
- The whole model through ``convert.lm_params_from_numpy``: prefill
  logits, the stacked SSM caches and teacher-forced decode logits against
  the reference (its layer scan compiled, as it serves) at
  ``tests/test_torch_lm.py``'s ``ATOL`` / ``MEAN_TOL`` and for its reasons,
  at prompts of 20 (one padded chunk) and 45 (two chunks); the prefill's
  logits also against the reference compiled with XLA's excess precision
  off (``_STRICT``: each bf16 step rounded, as in its op-by-op run), where
  a bf16 ulp may flip in a logit at most. ``Engine.generate`` against
  ``repro.serve.Engine``.

The reference's parameters are rounded to bf16 where the port stores bf16
(every leaf of more than one dim, as the reference's serving launcher casts
them). Inputs are made with numpy from a seed.
"""
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
from repro.models import prefill as jprefill
from repro.models import ssm as jssm
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import (LM, SSMCache, check_ported, decode_step,
                                init_cache, prefill)
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.serve import Engine, ServeConfig

ARCH = "mamba2-370m@smoke"
#: compile the reference without excess precision: every bf16 step rounds
#: to bf16, as in its op-by-op run
_STRICT = dict(compiler_options={"xla_allow_excess_precision": False})
ATOL = 0.0625
MEAN_TOL = 0.01
F32 = dict(rtol=1e-5, atol=1e-5)
B, STEPS = 3, 5


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
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


def _layer(seed=3):
    """One ``mamba2_init`` tree (bf16 values) in both packages."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    p, _ = jssm.mamba2_init(jax.random.PRNGKey(seed), jcfg)
    # non-trivial per-head scalars (the init's are 0 and 1)
    rng = np.random.default_rng(seed)
    H = cfg.ssm_heads
    p["A_log"] = jnp.asarray(rng.normal(size=H).astype(np.float32) * 0.5)
    p["dt_bias"] = jnp.asarray(rng.normal(size=H).astype(np.float32) * 0.5)
    p["D"] = jnp.asarray(rng.normal(size=H).astype(np.float32))
    p = _bf16_values(p)
    layer = tssm.Mamba2(cfg, "cpu")
    with torch.no_grad():
        for name, w in layer.named_parameters():
            w.copy_(torch.from_numpy(np.array(p[name], np.float32)))
    return jcfg, cfg, p, layer


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("S", [64, 45, 2])
def test_mamba2_apply_float32_matches_reference(S):
    jcfg, cfg, p, layer = _layer()
    x = _x((B, S, cfg.d_model), S)
    yj, cj = jax.jit(lambda p, x: jssm.mamba2_apply(p, jcfg, x, None,
                                                    jnp.int32(S)))(
        p, jnp.asarray(x))
    yt, ct = tssm.mamba2_apply(layer, cfg, torch.as_tensor(x), None, S)
    assert yt.dtype == torch.float32 and isinstance(ct, SSMCache)
    assert ct.state.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), _f32(yj), **F32)
    np.testing.assert_allclose(ct.conv.numpy(), _f32(cj.conv), **F32)
    np.testing.assert_allclose(ct.state.numpy(), _f32(cj.state), **F32)
    if S < cfg.conv_width - 1:  # the window still holds a zero row
        assert (ct.conv[:, 0] == 0).all()

    # one decode step from that cache, written in place
    xd = _x((B, 1, cfg.d_model), S + 1)
    yj, cj = jax.jit(lambda p, x, c: jssm.mamba2_apply(p, jcfg, x, c,
                                                       jnp.int32(S)))(
        p, jnp.asarray(xd), cj)
    cache = SSMCache(ct.conv.clone(), ct.state.clone())
    yt, ct2 = tssm.mamba2_apply(layer, cfg, torch.as_tensor(xd), cache, S)
    assert ct2.state is cache.state and ct2.conv is cache.conv
    np.testing.assert_allclose(yt.numpy(), _f32(yj), **F32)
    np.testing.assert_allclose(cache.state.numpy(), _f32(cj.state), **F32)
    np.testing.assert_allclose(cache.conv.numpy(), _f32(cj.conv), **F32)


def test_chunked_prefill_equals_the_recurrent_decode():
    """S = 45 (two chunks, the second padded): the SSD prefill's outputs
    and final state against 45 decode steps from a zeroed cache, float32."""
    _, cfg, _, layer = _layer(seed=4)
    S = 45
    x = torch.as_tensor(_x((B, S, cfg.d_model), 9))
    y, pre = tssm.mamba2_apply(layer, cfg, x, None, S)
    cache = tssm.init_ssm_cache(cfg, B, torch.float32, "cpu")
    ys = [tssm.mamba2_apply(layer, cfg, x[:, t: t + 1], cache, t)[0]
          for t in range(S)]
    torch.testing.assert_close(torch.cat(ys, dim=1), y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache.state, pre.state, rtol=1e-4, atol=1e-4)
    # the window's rows are x·w products taken one token at a time here
    torch.testing.assert_close(cache.conv, pre.conv, **F32)


def test_bf16_steps_equal_the_reference_op_by_op():
    """``silu`` and ``_conv1d`` (a prefill window, then one step on it) in
    bf16 equal the reference run op by op, bit for bit; a whole
    ``mamba2_apply`` but for rare one-ulp flips (``_ulp_flips``)."""
    jcfg, cfg, p, layer = _layer(seed=5)
    x = 3 * _x((B, 20, 160), 1)
    xj, xt = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    w = 0.5 * _x((4, 160), 2)
    wj, wt = jnp.asarray(w, jnp.bfloat16), torch.as_tensor(w).bfloat16()
    with jax.disable_jit():
        sj = jax.nn.silu(xj)
        oj, prev_j = jssm._conv1d(xj, wj, None)
        oj1, _ = jssm._conv1d(xj[:, :1], wj, prev_j)
        pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim > 1
                          else a, p)
        xm = jnp.asarray(_x((B, 20, cfg.d_model), 3), jnp.bfloat16)
        yj, _ = jssm.mamba2_apply(pj, jcfg, xm)
    np.testing.assert_array_equal(tlayers.silu(xt).float().numpy(), _f32(sj))
    ot, prev_t = tssm._conv1d(xt, wt, None)
    np.testing.assert_array_equal(ot.float().numpy(), _f32(oj))
    np.testing.assert_array_equal(prev_t.float().numpy(), _f32(prev_j))
    ot1, _ = tssm._conv1d(xt[:, :1], wt, prev_t)
    np.testing.assert_array_equal(ot1.float().numpy(), _f32(oj1))
    yt, _ = tssm.mamba2_apply(layer, cfg, torch.as_tensor(
        _f32(xm)).bfloat16())
    _ulp_flips(yt, yj)
    # the reference compiled with ``_STRICT`` is its op-by-op run
    ys, _ = jax.jit(lambda p, x: jssm.mamba2_apply(p, jcfg, x), **_STRICT)(
        pj, xm)
    np.testing.assert_array_equal(_f32(ys), _f32(yj))


def _ulp_flips(got: torch.Tensor, want, share: float = 1e-3) -> None:
    """bf16 ``got`` equals ``want`` but for at most ``share`` of its values,
    each one bf16 ulp away: the float32 sums inside (the projections, the
    SSD einsums) are taken in another order, and a value near a rounding
    boundary may land on the other side."""
    got, want = got.float().numpy(), _f32(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    diff = np.abs(got - want)
    assert (diff <= ulp).all(), float((diff / ulp).max())
    assert (diff > 0).mean() <= share, (diff > 0).mean()


def test_softplus_is_logaddexp():
    x = np.concatenate([np.linspace(-100, 100, 2001, dtype=np.float32),
                        np.array([0.0, 20.5, -1e-8], np.float32)])
    np.testing.assert_allclose(
        tlayers.softplus(torch.as_tensor(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    params = jax.jit(lambda k: jinit(jcfg, k)[0])(jax.random.PRNGKey(1))
    params = _bf16_values(params)
    m = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return jcfg, params, cfg, m


@pytest.mark.parametrize("S0", [20, 45])
def test_prefill_cache_and_teacher_forced_decode(model, S0):
    jcfg, params, cfg, m = model
    toks = np.random.default_rng(S0).integers(
        0, cfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :S0])}
    jc, jl = jax.jit(lambda p, b: jprefill(p, jcfg, b))(params, batch)
    tc, tl = prefill(m, torch.as_tensor(toks[:, :S0]))
    assert isinstance(tc, SSMCache) and tc.state.shape == (
        cfg.n_layers, B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
    _close(tl, jl)
    _close(tc.conv, jc["layers"]["b0"]["ssm"].conv)
    _close(tc.state, jc["layers"]["b0"]["ssm"].state)
    _, jl_op = jax.jit(lambda p, b: jprefill(p, jcfg, b), **_STRICT)(
        params, batch)
    d = np.abs(tl.float().numpy() - _f32(jl_op))
    assert d.max() <= 2.0 ** -6 and d.mean() <= 1e-4, (d.max(), d.mean())

    L = S0 + STEPS
    jdec, _ = jinit_cache(jcfg, B, L)
    jdec = JEngine(jcfg, params, JServeConfig(max_len=L))._merge_caches(
        jdec, jc, S0)
    tdec = Engine(cfg, m, ServeConfig(max_len=L))._merge_caches(
        init_cache(cfg, B, L, device="cpu"), tc, S0)
    step = jax.jit(lambda p, c, t, pos: jdecode_step(p, jcfg, c, t, pos))
    for i in range(STEPS):
        tok = toks[:, S0 + i]
        jdec, jl = step(params, jdec, jnp.asarray(tok), jnp.int32(S0 + i))
        tdec, tl = decode_step(m, tdec, torch.as_tensor(tok), S0 + i)
        _close(tl, jl)
    _close(tdec.conv, jdec["layers"]["b0"]["ssm"].conv)
    _close(tdec.state, jdec["layers"]["b0"]["ssm"].state)


def test_generate_tokens_equal_where_the_gap_is_clear(model):
    """Engine.generate in both packages, compared as
    ``tests/test_torch_lm.py`` compares them (up to the first step where
    the two greedy paths part on a near tie)."""
    jcfg, params, cfg, m = model
    S0 = 24
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S0)).astype(np.int32)
    jeng = JEngine(jcfg, params, JServeConfig(max_len=S0 + STEPS))
    want = np.asarray(jeng.generate({"tokens": jnp.asarray(prompt)}, STEPS))
    got = Engine(cfg, m, ServeConfig(max_len=S0 + STEPS)).generate(
        torch.as_tensor(prompt), STEPS)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    got = got.numpy()
    jc, jl = jprefill(params, jcfg, {"tokens": jnp.asarray(prompt)})
    jdec, _ = jinit_cache(jcfg, B, S0 + STEPS)
    jdec = jeng._merge_caches(jdec, jc, S0)
    same = np.ones(B, bool)
    checked = 0
    for i in range(STEPS):
        top2 = np.sort(_f32(jl), axis=-1)[:, -2:]
        clear = same & (top2[:, 1] - top2[:, 0] > 2 * ATOL)
        np.testing.assert_array_equal(got[clear, i], want[clear, i])
        checked += int(clear.sum())
        same &= got[:, i] == want[:, i]
        jdec, jl = jdecode_step(params, jcfg, jdec, jnp.asarray(want[:, i]),
                                jnp.int32(S0 + i))
    assert checked > 0


def test_ssm_configs_build_for_cuda_by_default(monkeypatch):
    """mamba2-370m passes ``check_ported`` for the default device (CUDA) at
    full width; without a card the build then asks for one (it does not
    fall back to the CPU). The engine still refuses a prompt past
    ``max_len`` (an SSM has no ring)."""
    cfg = get_config("mamba2-370m")
    check_ported(cfg)
    check_ported(cfg, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM(get_config(ARCH))
    small = get_config(ARCH)
    m = LM(small, "cpu")
    with pytest.raises(ValueError, match="max_len"):
        Engine(small, m, ServeConfig(max_len=8)).generate(
            torch.zeros((1, 6), dtype=torch.int64), 3)
