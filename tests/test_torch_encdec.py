"""Encoder-decoder serving on the CPU: the port's whisper path against the
live JAX package at ``whisper-tiny@smoke`` (2 encoder and 2 decoder layers,
d_model 64, 4 heads of 16, enc_len 64, learned positions up to 128).

- ``_sinusoid`` in float32 against the reference's, at the smoke shape and
  at whisper-tiny's own [1500, 384]: atol 1e-5 (angles reach 1499 rad,
  where the float32 spacing is 1.2e-4 and the two libraries' sin/cos
  range reductions differ by up to ~4e-6).
- The encoder (``_encode``: bf16 frames plus the sinusoid, bidirectional
  blocks without rope, ``enc_ln``), the prefill's last-position logits, both
  cache fields (the decoder's self K/V and the cross K/V of the encoder's
  output), teacher-forced decode logits over the cross cache, and
  ``Engine.generate``'s greedy tokens where the reference's top-2 gap is
  clear, through ``convert.lm_params_from_numpy``.
- The ``attention=`` hook reaches the encoder's bidirectional layers (with
  ``causal=False``) and the decoder's causal ones; K5's wrapper in its
  place (its plain version on the CPU) gives the ``_sdpa`` prefill's
  logits.
- ``prefill`` refuses missing frames and frames of another length than
  ``enc_len``.

Tolerances are ``tests/test_torch_lm.py``'s: both packages compute in bf16
and round at different places, so ``ATOL`` = 0.0625 (four bf16 ulps at
the logits' magnitude) and ``MEAN_TOL`` = 0.01 on the mean absolute
difference; greedy tokens must be equal wherever the reference's top-2 gap
exceeds ``2 * ATOL``. The reference is compiled with XLA's excess
precision off (``_STRICT``), so each of its bf16 steps rounds as its
op-by-op run does. Inputs are made with numpy from a seed.
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
from repro.models import model as jmodel
from repro.models import prefill as jprefill
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attn as K5
from repro_torch.models import EncDecCache, decode_step, init_cache, prefill
from repro_torch.models import model as tmodel
from repro_torch.serve import Engine, ServeConfig

ARCH = "whisper-tiny@smoke"
_STRICT = dict(compiler_options={"xla_allow_excess_precision": False})
ATOL = 0.0625
MEAN_TOL = 0.01
B, S0, STEPS = 2, 24, 6


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got: torch.Tensor, want) -> None:
    want = _f32(want)
    got = got.float().numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= ATOL, diff.max()
    assert diff.mean() <= MEAN_TOL, diff.mean()


@pytest.fixture(scope="module")
def ref():
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    params, _ = jinit(jcfg, jax.random.PRNGKey(3))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    rng = np.random.default_rng(24)
    toks = rng.integers(0, cfg.vocab, (B, S0 + STEPS)).astype(np.int32)
    frames = rng.normal(size=(B, cfg.enc_len, cfg.d_model)).astype(np.float32)
    pre = jax.jit(lambda p, b: jprefill(p, jcfg, b), **_STRICT)
    step = jax.jit(lambda p, c, t, pos: jdecode_step(p, jcfg, c, t, pos),
                   **_STRICT)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, toks=toks,
                frames=frames, pre=pre, step=step)


@pytest.mark.parametrize("n,d", [(64, 64), (1500, 384)])
def test_sinusoid_matches_reference(n, d):
    got = tmodel._sinusoid(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), _f32(jmodel._sinusoid(n, d)),
                               rtol=0, atol=1e-5)


def test_encoder_matches_reference(ref):
    enc = jax.jit(lambda p, f: jmodel._encode(p, ref["jcfg"], f),
                  **_STRICT)(ref["params"], jnp.asarray(ref["frames"]))
    got = tmodel._encode(ref["model"], torch.as_tensor(ref["frames"]))
    assert got.dtype == torch.bfloat16
    _close(got, enc)


def test_prefill_caches_and_teacher_forced_decode(ref):
    cfg, params, model, toks = ref["cfg"], ref["params"], ref["model"], \
        ref["toks"]
    frames = ref["frames"]
    jc, jl = ref["pre"](params, {"tokens": jnp.asarray(toks[:, :S0]),
                                 "frames": jnp.asarray(frames)})
    tc, tl = prefill(model, torch.as_tensor(toks[:, :S0]),
                     frames=torch.as_tensor(frames))
    assert isinstance(tc, EncDecCache)
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    assert tc.attn.k.shape == (L, B, S0, K, hd)
    assert tc.cross.k.shape == (L, B, cfg.enc_len, K, hd)
    _close(tl, jl)
    jb0 = jc["layers"]["b0"]
    for got, want in ((tc.attn.k, jb0["attn"].k), (tc.attn.v, jb0["attn"].v),
                      (tc.cross.k, jb0["cross"].k),
                      (tc.cross.v, jb0["cross"].v)):
        _close(got, want)

    # the engines' hand-off: self K/V into the first S0 slots, the cross
    # K/V copied whole
    n = S0 + STEPS
    jdec, _ = jinit_cache(ref["jcfg"], B, n)
    jdec = JEngine(ref["jcfg"], params, JServeConfig(max_len=n)) \
        ._merge_caches(jdec, jc, S0)
    tdec = Engine(cfg, model, ServeConfig(max_len=n))._merge_caches(
        init_cache(cfg, B, n, device="cpu"), tc, S0)
    assert torch.equal(tdec.cross.k, tc.cross.k)
    cross = tdec.cross.k.clone()
    for i in range(STEPS):
        tok = toks[:, S0 + i]
        jdec, jl = ref["step"](params, jdec, jnp.asarray(tok),
                               jnp.int32(S0 + i))
        tdec, tl = decode_step(model, tdec, torch.as_tensor(tok), S0 + i)
        _close(tl, jl)
    _close(tdec.attn.k, jdec["layers"]["b0"]["attn"].k)
    assert torch.equal(tdec.cross.k, cross)  # decode never writes it


def test_generate_tokens_equal_where_the_gap_is_clear(ref):
    """Engine.generate in both packages; a sequence is compared up to the
    first step where the two greedy paths part (on a near tie)."""
    jcfg, cfg, params = ref["jcfg"], ref["cfg"], ref["params"]
    prompt, frames = ref["toks"][:, :S0], ref["frames"]
    n = S0 + STEPS
    jeng = JEngine(jcfg, params, JServeConfig(max_len=n))
    jeng._prefill = ref["pre"]
    jeng._decode = ref["step"]
    batch = {"tokens": jnp.asarray(prompt), "frames": jnp.asarray(frames)}
    want = np.asarray(jeng.generate(batch, STEPS))
    got = Engine(cfg, ref["model"], ServeConfig(max_len=n)).generate(
        torch.as_tensor(prompt), STEPS, frames=torch.as_tensor(frames))
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    got = got.numpy()

    jc, jl = ref["pre"](params, batch)
    jdec, _ = jinit_cache(jcfg, B, n)
    jdec = jeng._merge_caches(jdec, jc, S0)
    same = np.ones(B, bool)
    checked = 0
    for i in range(STEPS):
        top2 = np.sort(_f32(jl), axis=-1)[:, -2:]
        clear = same & (top2[:, 1] - top2[:, 0] > 2 * ATOL)
        np.testing.assert_array_equal(got[clear, i], want[clear, i])
        checked += int(clear.sum())
        same &= got[:, i] == want[:, i]
        jdec, jl = ref["step"](params, jdec, jnp.asarray(want[:, i]),
                               jnp.int32(S0 + i))
    assert checked > 0


def test_attention_hook_reaches_the_encoder(ref):
    """Each encoder layer hands the hook ``causal=False`` (and no window),
    each decoder layer the causal call; K5's wrapper in its place gives the
    ``_sdpa`` prefill's logits to float rounding."""
    cfg, model = ref["cfg"], ref["model"]
    prompt = torch.as_tensor(ref["toks"][:, :S0])
    frames = torch.as_tensor(ref["frames"])
    seen = []

    def spy(q, k, v, scale=None, window=None, causal=True):
        seen.append((q.shape[1], causal, window))
        return K5.flash_attention(q, k, v, scale=scale, window=window,
                                  causal=causal)

    cache_k, logits_k = prefill(model, prompt, frames=frames, attention=spy)
    cache_c, logits_c = prefill(model, prompt, frames=frames)
    assert seen == [(cfg.enc_len, False, None)] * cfg.enc_layers + \
        [(S0, True, None)] * cfg.n_layers
    torch.testing.assert_close(logits_k.float(), logits_c.float(), rtol=0,
                               atol=ATOL)
    torch.testing.assert_close(cache_k.cross.k.float(),
                               cache_c.cross.k.float(), rtol=0, atol=ATOL)


def test_prefill_refuses_missing_or_misfit_frames(ref):
    cfg, model = ref["cfg"], ref["model"]
    prompt = torch.as_tensor(ref["toks"][:, :S0])
    with pytest.raises(ValueError, match="needs frames"):
        prefill(model, prompt)
    with pytest.raises(ValueError, match="enc_len"):
        prefill(model, prompt, frames=torch.zeros((B, cfg.enc_len - 1,
                                                   cfg.d_model)))
    with pytest.raises(ValueError, match="no vision frontend"):
        prefill(model, prompt, frames=torch.as_tensor(ref["frames"]),
                images=torch.zeros((B, 4, cfg.d_model)))
