"""K5's plain backward under every mask of the forward, and the SSD's
gradient at the published chunk of 256, on the CPU against the live JAX
package.

- ``flash_attention_backward_plain`` (the card's yardstick for the
  backward kernel) with ``causal=False`` at a ragged S 100 (64/64), and
  with a window (16/16 at S 64, W 32; 256/256 at S 300, W 100, two query
  heads on one KV head) against ``jax.vjp`` of the reference's ``_sdpa``
  under the same mask (K/V repeated to H heads inside the function, so
  their cotangents sum over each group), in float32; the row statistic
  against the masked logits' logsumexp; and autograd through the plain
  forward on the CPU equal to it.
- The SSD (``models/ssm.py``): the reference's ``loss_fn`` gradients at
  mamba2-370m@smoke with ``ssm_chunk`` 256 over S 256 are not finite
  (``exp`` of the decay above the diagonal overflows before its mask);
  the port's are finite, its loss matches the reference's at chunk 32 and
  its gradients its own at chunk 32; ``mamba2_apply``'s float32 gradient
  at chunk 256 matches the reference's at chunk 32 (the SSD's output does
  not depend on the chunk), where the reference's at chunk 256 is not
  finite; the masked exponential equals the reference's ``where`` form bit
  for bit, so the forward is unchanged.
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
from repro.models import init as jinit
from repro.models import loss_fn as jloss_fn
from repro.models import ssm as jssm
from repro.train.loop import _cast_bf16
from repro_torch.configs import get_config
from repro_torch.convert import _reference_leaves, lm_params_from_numpy
from repro_torch.kernels import flash_attn as K5
from repro_torch.models import loss_fn
from repro_torch.models import ssm as tssm

#: float32 in both frameworks, sums in another order over at most 300
#: keys of O(1) terms (measured: at most ~2e-6)
F32 = dict(rtol=1e-4, atol=1e-5)


def _inputs(B, S, H, K, dqk, dv, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, dqk), (B, S, K, dqk), (B, S, K, dv), (B, S, H, dv))]


@pytest.mark.parametrize("B,S,H,K,dqk,dv,window,causal", [
    (1, 100, 2, 2, 64, 64, None, False), (2, 64, 4, 2, 16, 16, 32, True),
    (1, 300, 2, 1, 256, 256, 100, True)],
    ids=["noncausal-ragged", "window-16", "window-256"])
def test_plain_backward_matches_vjp_of_reference_sdpa(B, S, H, K, dqk, dv,
                                                      window, causal):
    q, k, v, dout = _inputs(B, S, H, K, dqk, dv, S + dqk)
    scale = 1.0 / math.sqrt(dqk)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def ref(q, k, v):
        return jattn._sdpa(q, jattn._repeat_kv(k, H), jattn._repeat_kv(v, H),
                           scale, qpos=pos, kpos=pos, causal=causal,
                           window=window)

    out_j, vjp = jax.vjp(ref, *(jnp.asarray(t) for t in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, dout))
    got = K5.flash_attention_backward_plain(tq, tk, tv, tdo, scale, window,
                                            causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, torch.from_numpy(np.asarray(w)), **F32)
    out, lse, _ = K5.flash_attention_lse_plain(tq, tk, tv, scale, window,
                                               causal)
    torch.testing.assert_close(out, torch.from_numpy(np.asarray(out_j)),
                               **F32)
    logits = np.einsum("bqhd,bkhd->bhqk", q,
                       np.repeat(k, H // K, axis=2)) * scale
    if causal:
        i, j = np.arange(S)[:, None], np.arange(S)[None, :]
        logits = np.where((j <= i) & (j > i - window), logits, -np.inf)
    want_lse = np.logaddexp.reduce(logits, axis=-1) * K5.LOG2E
    torch.testing.assert_close(lse, torch.from_numpy(
        want_lse.astype(np.float32)), **F32)
    # the CPU's autograd through the plain forward: the same gradients
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    K5.flash_attention(*leaves, scale=scale, window=window,
                       causal=causal).backward(tdo)
    for t, w in zip(leaves, got):
        torch.testing.assert_close(t.grad, w, **F32)


# ----------------------------------------------------- SSD at a chunk of 256
SSD_ARCH, SSD_S = "mamba2-370m@smoke", 256
#: the model's loss at chunk 256 against the reference's at chunk 32:
#: ``tests/test_torch_train_encdec_hybrid_ssm.py``'s bound (measured here
#: 1.1e-3)
LOSS_ATOL = 5e-3
#: the model's gradients at chunk 256 against its own at chunk 32, leaf by
#: leaf: the same bf16 model, only the SSD's float32 sums taken in other
#: chunks (measured: at most 0.013 of a leaf's max, 0.011 of its mean, at
#: ``layers.0.ssm.A_log``, 4 values that sum cancelling terms)
GRAD_ATOL_REL, GRAD_MEAN_REL = 2.0 ** -5, 2.0 ** -6
#: mamba2_apply in float32, the port at chunk 256 against the reference at
#: chunk 32: float32 sums in other chunks and another order (measured: the
#: largest |diff| / (|want| + 1e-4) 0.016, where A_log's and dt_bias's
#: sums cancel)
SSD_F32 = dict(rtol=1e-3, atol=1e-4)


def _ssd_case(chunk: int):
    jcfg = dataclasses.replace(jget_config(SSD_ARCH), ssm_chunk=chunk)
    cfg = dataclasses.replace(get_config(SSD_ARCH), ssm_chunk=chunk)
    return jcfg, cfg


@pytest.fixture(scope="module")
def ssd():
    """The reference's tree (numpy: norms 1, the rest N(0, 1)/√d), tokens
    [1, S+1], its loss and gradients at chunk 256 and its loss at chunk
    32."""
    jcfg, _ = _ssd_case(256)
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda k: jinit(jcfg, k)[0],
                            jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.ones(leaf.shape, np.float32)
        if path[-1].key in ("ln1", "final_ln", "norm") else
        (rng.standard_normal(leaf.shape) / np.sqrt(jcfg.d_model)).astype(
            np.float32), shapes)
    tokens = rng.integers(0, jcfg.vocab, (1, SSD_S + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    strict = dict(compiler_options={"xla_allow_excess_precision": False})
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True), **strict)(
            _cast_bf16(tree), batch)
    jc32 = _ssd_case(32)[0]
    loss32 = jax.jit(lambda p, b: jloss_fn(p, jc32, b)[0], **strict)(
        _cast_bf16(tree), batch)
    return dict(tree=tree, tokens=tokens, loss=float(loss),
                grads=jax.tree.map(np.asarray, grads), loss32=float(loss32))


def test_reference_ssd_gradient_is_not_finite_at_chunk_256(ssd):
    """The reference's fault (ROADMAP queue 3): at chunk 256 its loss is
    finite and its gradients are not, in most leaves, the embedding among
    them."""
    assert math.isfinite(ssd["loss"])
    flat = jax.tree_util.tree_flatten_with_path(ssd["grads"])[0]
    bad = [".".join(k.key for k in kp) for kp, g in flat
           if not np.isfinite(np.asarray(g, np.float32)).all()]
    assert "embed" in bad and len(bad) > len(flat) // 2, bad


def _port_grads(tree, tokens, chunk: int):
    _, cfg = _ssd_case(chunk)
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    params = list(model.parameters())
    for p in params:
        p.requires_grad_(True)
    loss, _ = loss_fn(model, {"tokens": torch.from_numpy(tokens)})
    names = [n for n, *_ in _reference_leaves(cfg, model)]
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(
        loss, params)))


def test_port_ssd_gradient_at_chunk_256_is_finite(ssd):
    """The model at chunk 256: every leaf's gradient finite and within the
    tolerances of its own at chunk 32; the loss within ``LOSS_ATOL`` of
    the reference's at chunk 32."""
    loss, grads = _port_grads(ssd["tree"], ssd["tokens"], 256)
    _, want = _port_grads(ssd["tree"], ssd["tokens"], 32)
    assert abs(loss - ssd["loss32"]) <= LOSS_ATOL
    for name, g in grads.items():
        g, w = g.float(), want[name].float()
        assert bool(torch.isfinite(g).all()), name
        d = (g - w).abs()
        assert float(d.max()) <= GRAD_ATOL_REL * float(w.abs().max()), name
        assert float(d.mean()) <= GRAD_MEAN_REL * float(w.abs().mean()), name


def test_ssd_gradient_at_chunk_256_matches_the_reference_at_chunk_32():
    """``mamba2_apply`` in float32 over S 256 (A = -exp(A_log) near -1, dt
    near 0.7: the decay passes 88.7 within the chunk): the reference's
    gradient at chunk 256 is not finite; the port's at chunk 256 equals the
    reference's at chunk 32 (x and every parameter) within float32
    rounding."""
    jcfg256, cfg = _ssd_case(256)
    jcfg32, _ = _ssd_case(32)
    rng = np.random.default_rng(3)
    p, _ = jssm.mamba2_init(jax.random.PRNGKey(3), jcfg32)
    H = cfg.ssm_heads
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    p["A_log"] = (rng.normal(size=H) * 0.5).astype(np.float32)
    p["dt_bias"] = (rng.normal(size=H) * 0.5).astype(np.float32)
    p["D"] = rng.normal(size=H).astype(np.float32)
    x = rng.normal(size=(1, SSD_S, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def ref_grads(jc):
        def f(p, x, dy):
            return jax.vjp(lambda p, x: jssm.mamba2_apply(p, jc, x)[0], p,
                           x)[1](dy)
        return jax.jit(f)(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                          jnp.asarray(dy))

    bad_p, bad_x = ref_grads(jcfg256)
    assert not np.isfinite(np.asarray(bad_x)).all()
    want_p, want_x = ref_grads(jcfg32)
    layer = tssm.Mamba2(cfg, "cpu").float()
    with torch.no_grad():
        for name, w in layer.named_parameters():
            w.copy_(torch.from_numpy(p[name]))
            w.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = tssm.mamba2_apply(layer, cfg, xt)
    y.backward(torch.from_numpy(dy))
    torch.testing.assert_close(xt.grad, torch.from_numpy(
        np.asarray(want_x)), **SSD_F32)
    for name, w in layer.named_parameters():
        assert w.grad is not None and bool(torch.isfinite(w.grad).all()), \
            name
        torch.testing.assert_close(w.grad, torch.from_numpy(
            np.asarray(want_p[name])), **SSD_F32)


def test_masked_exponential_equals_the_where_form():
    """The decay matrix of a chunk of 256 (dt softplus'd, A = -exp(A_log)):
    the reference's ``where(tri, exp(diff), 0)`` overflows to inf above the
    diagonal and keeps 0 there; the port's ``exp`` of the masked ``diff``
    is the same array bit for bit, with no inf to meet in the backward."""
    g = torch.Generator().manual_seed(1)
    dt = torch.nn.functional.softplus(torch.randn((2, 256, 4), generator=g))
    A = -torch.exp(torch.randn((4,), generator=g) / 8)
    cum = torch.cumsum(dt * A, dim=1)
    diff = cum[:, :, None, :] - cum[:, None, :, :]
    tri = torch.ones((256, 256), dtype=torch.bool).tril()[None, :, :, None]
    assert torch.isinf(torch.exp(diff)).any()
    where_form = torch.where(tri, torch.exp(diff), 0.0)
    masked = torch.exp(diff.masked_fill(~tri, -math.inf))
    assert torch.equal(masked, where_form)
    assert torch.isfinite(masked).all()
