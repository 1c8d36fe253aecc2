"""The vision frontend on the CPU: the port's pixtral path against the live
JAX package at ``pixtral-12b@smoke`` (the mistral-nemo backbone at smoke
width: 2 layers, d_model 64, 4 query heads on 2 KV heads of 16; 16 patch
embeddings an image).

The patch embeddings (``images`` [B, 16, d], precomputed as the
reference's stub has them) replace the first min(n_patches, S) slots of
the prompt's token embeddings, cast to bf16: at a 24-token prompt (16
patches, then 8 tokens), at a 10-token prompt (shorter than n_patches: only
its 10 slots are patches) and without images (the plain backbone). For
each: the prefill's last-position logits and K/V cache, teacher-forced
decode logits, and ``Engine.generate``'s greedy tokens where the
reference's top-2 gap is clear, through ``convert.lm_params_from_numpy``.

Tolerances are ``tests/test_torch_lm.py``'s: ``ATOL`` = 0.0625 (four bf16
ulps at the logits' magnitude) and ``MEAN_TOL`` = 0.01 on the mean absolute
difference; greedy tokens must be equal wherever the reference's top-2 gap
exceeds ``2 * ATOL``. The reference is compiled with XLA's excess
precision off (``_STRICT``), as in ``tests/test_torch_hybrid.py``. Inputs
are made with numpy from a seed.
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
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.serve import Engine, ServeConfig

ARCH = "pixtral-12b@smoke"
_STRICT = dict(compiler_options={"xla_allow_excess_precision": False})
ATOL = 0.0625
MEAN_TOL = 0.01
B, STEPS = 2, 6


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
    params, _ = jinit(jcfg, jax.random.PRNGKey(5))
    model = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    rng = np.random.default_rng(16)
    toks = rng.integers(0, cfg.vocab, (B, 24 + STEPS)).astype(np.int32)
    # patch embeddings at the token embeddings' scale (1/sqrt(d))
    images = (rng.normal(size=(B, cfg.n_patches, cfg.d_model))
              / np.sqrt(cfg.d_model)).astype(np.float32)
    pre = jax.jit(lambda p, b: jprefill(p, jcfg, b), **_STRICT)
    step = jax.jit(lambda p, c, t, pos: jdecode_step(p, jcfg, c, t, pos),
                   **_STRICT)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, toks=toks,
                images=images, pre=pre, step=step)


CASES = [(24, True), (10, True), (24, False)]
IDS = ["prompt24-images", "prompt10-images", "prompt24-no-images"]


def _inputs(ref, S0, with_images):
    jb = {"tokens": jnp.asarray(ref["toks"][:, :S0])}
    tkw = {}
    if with_images:
        jb["images"] = jnp.asarray(ref["images"])
        tkw["images"] = torch.as_tensor(ref["images"])
    return jb, torch.as_tensor(ref["toks"][:, :S0]), tkw


@pytest.mark.parametrize("S0,with_images", CASES, ids=IDS)
def test_prefill_and_teacher_forced_decode(ref, S0, with_images):
    cfg, params, model = ref["cfg"], ref["params"], ref["model"]
    jb, prompt, tkw = _inputs(ref, S0, with_images)
    jc, jl = ref["pre"](params, jb)
    tc, tl = prefill(model, prompt, **tkw)
    assert tc.k.shape == (cfg.n_layers, B, S0, cfg.n_kv_heads, cfg.head_dim)
    _close(tl, jl)
    _close(tc.k, jc["layers"]["b0"]["attn"].k)
    _close(tc.v, jc["layers"]["b0"]["attn"].v)

    n = S0 + STEPS
    jdec, _ = jinit_cache(ref["jcfg"], B, n)
    jdec = jax.tree.map(lambda z, c: z.at[:, :, :S0].set(c), jdec, jc)
    tdec = Engine(cfg, model, ServeConfig(max_len=n))._merge_caches(
        init_cache(cfg, B, n, device="cpu"), tc, S0)
    for i in range(STEPS):
        tok = ref["toks"][:, S0 + i]
        jdec, jl = ref["step"](params, jdec, jnp.asarray(tok),
                               jnp.int32(S0 + i))
        tdec, tl = decode_step(model, tdec, torch.as_tensor(tok), S0 + i)
        _close(tl, jl)
    _close(tdec.k, jdec["layers"]["b0"]["attn"].k)


@pytest.mark.parametrize("S0,with_images", CASES, ids=IDS)
def test_generate_tokens_equal_where_the_gap_is_clear(ref, S0, with_images):
    jcfg, cfg, params = ref["jcfg"], ref["cfg"], ref["params"]
    jb, prompt, tkw = _inputs(ref, S0, with_images)
    n = S0 + STEPS
    jeng = JEngine(jcfg, params, JServeConfig(max_len=n))
    jeng._prefill = ref["pre"]
    jeng._decode = ref["step"]
    want = np.asarray(jeng.generate(jb, STEPS))
    got = Engine(cfg, ref["model"], ServeConfig(max_len=n)).generate(
        prompt, STEPS, **tkw)
    assert got.dtype == torch.int32 and got.shape == (B, STEPS)
    got = got.numpy()

    jc, jl = ref["pre"](params, jb)
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


def test_images_move_the_logits_and_are_checked(ref):
    """The frontend is wired: the same prompt's logits with and without
    images differ by O(1) (the tolerance rejects the difference), and
    images of the wrong shape are refused."""
    cfg, model = ref["cfg"], ref["model"]
    prompt = torch.as_tensor(ref["toks"][:, :24])
    images = torch.as_tensor(ref["images"])
    _, with_images = prefill(model, prompt, images=images)
    _, without = prefill(model, prompt)
    diff = (with_images.float() - without.float()).abs()
    assert float(diff.max()) > 4 * ATOL and float(diff.mean()) > MEAN_TOL
    with pytest.raises(ValueError, match="images must be"):
        prefill(model, prompt, images=images[:, :8])
    with pytest.raises(ValueError, match="images must be"):
        prefill(model, prompt, images=images[..., :32])
    with pytest.raises(ValueError, match="no encoder"):
        prefill(model, prompt, frames=torch.zeros((B, 4, cfg.d_model)))
