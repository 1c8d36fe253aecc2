"""Training on the CPU: the port's loss, gradients, optimizer, gradient
compression and train step against the live JAX package, on the same numpy
inputs.

- ``cross_entropy`` (value and both gradients) at one chunk and at a vocab
  that 16 does not divide (245: 5 chunks with the running max and sum),
  bf16 inputs as the model feeds it.
- ``loss_fn`` at ``mistral-nemo-12b@smoke`` and ``qwen3-14b@smoke``
  (qk-norm): the loss and every leaf's gradient with respect to the bf16
  compute copy (the reference's ``_cast_bf16`` of its ``init`` tree, loaded
  into the port's ``LM``), and the port's ``remat`` on equal to off bit for
  bit.
- ``adamw_update`` and ``cosine_lr`` on identical float32 gradients.
- 3 steps of ``make_train_step`` from the same masters and tokens: one
  batch, 2 microbatches, and ``compress_grads``; and a state saved by the
  reference (``repro.train.save``) read back through
  ``convert.train_state_from_numpy``, from which both sides take a step.
- ``quantize_tree``'s int8 payloads and scales equal to the reference's;
  ``bigram_entropy`` equal.

The reference's loss and train step are compiled with XLA's excess
precision off (``_STRICT``), so their bf16 steps round as each op alone
rounds (as PyTorch rounds them). Tolerances, with their reasons, are
stated by each test.
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
from repro.models import init as jinit
from repro.models import loss_fn as jloss_fn
from repro.models.layers import cross_entropy as jcross_entropy
from repro.parallel.collectives import init_error_feedback as jinit_ef
from repro.parallel.collectives import quantize_tree as jquantize_tree
from repro.train import DataConfig as JDataConfig
from repro.train import LRSchedule as JLRSchedule
from repro.train import TrainConfig as JTrainConfig
from repro.train import adamw_init as jadamw_init
from repro.train import adamw_update as jadamw_update
from repro.train import bigram_entropy as jbigram_entropy
from repro.train import cosine_lr as jcosine_lr
from repro.train import make_train_step as jmake_train_step
from repro.train import save as jsave
from repro.train.loop import _cast_bf16
from repro_torch.configs import get_config
from repro_torch.convert import (_leaf, _reference_leaves,
                                 lm_params_from_numpy,
                                 reference_checkpoint_tree,
                                 train_state_from_numpy)
from repro_torch.models import LM, loss_fn
from repro_torch.models.layers import cross_entropy
from repro_torch.parallel import init_error_feedback, quantize_tree
from repro_torch.train import (DataConfig, LRSchedule, TrainConfig,
                               adamw_init, adamw_update, bigram_entropy,
                               cosine_lr, make_train_step)

ARCHS = ["mistral-nemo-12b@smoke", "qwen3-14b@smoke"]
_STRICT = dict(compiler_options={"xla_allow_excess_precision": False})
B, S = 4, 32

#: loss values: the mean of B·S = 128 float32 cross entropies of bf16
#: logits (|logit| <~ 4, one bf16 ulp 2^-6); a one-ulp flip of a logit
#: between the two sides moves the mean by up to ~1.2e-4, and float32 sums
#: run in another order: within 1e-3, ~8 flips (measured: 0 to 1.5e-5 at
#: init, 2.5e-4 after one AdamW step). A wrong mask, label shift or head
#: moves it by O(0.1).
LOSS_ATOL = 1e-3
#: a gradient leaf: its values round once more after sums taken in
#: another order, and one-ulp bf16 flips (2^-8 relative) upstream carry
#: through two layers (measured over seeds 0-2 of both configs: at most
#: 0.0126 of the leaf's largest magnitude, and a mean difference of at
#: most 0.0086 of its mean magnitude, ~2 ulps): each element within 2^-5
#: of the leaf's max |value|, the mean difference within 2^-6 of its mean
#: |value|. A wrong mask, head or position moves gradients by O(1).
GRAD_ATOL_REL, GRAD_MEAN_REL = 2.0 ** -5, 2.0 ** -6


_NORMS = {"ln1", "ln2", "final_ln", "q_norm", "k_norm"}


def _ref_params(jcfg, seed: int) -> dict:
    """Parameters in the structure of the reference's ``init`` tree (its
    shapes from ``jax.eval_shape``, so nothing of ``init`` is compiled),
    drawn with numpy: norm scales 1 as ``init`` sets them, every other
    leaf N(0, 1)/√d_model (fan-in scale)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jinit(jcfg, k)[0],
                            jax.random.PRNGKey(0))

    def fill(path, leaf):
        if path[-1].key in _NORMS:
            return np.ones(leaf.shape, np.float32)
        z = rng.standard_normal(leaf.shape).astype(np.float32)
        return z / np.float32(np.sqrt(jcfg.d_model))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _np(t) -> np.ndarray:
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _grads_close(got: torch.Tensor, want, what: str) -> None:
    want = _np(want)
    got = got.float().numpy()
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    scale = np.abs(want).max()
    assert diff.max() <= GRAD_ATOL_REL * scale, (what, diff.max(), scale)
    assert diff.mean() <= GRAD_MEAN_REL * np.abs(want).mean(), \
        (what, diff.mean(), np.abs(want).mean())


def _tokens(cfg, seed: int, batch: int = B) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (batch, S + 1)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(reference cfg, its init tree (numpy), the port's cfg, the
    reference's jitted value_and_grad of its loss)."""
    jcfg = jget_config(request.param)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True), **_STRICT)
    return jcfg, _ref_params(jcfg, 0), get_config(request.param), grad_fn


def _compute_copy(cfg, tree) -> LM:
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    return model


# ----------------------------------------------------------- cross entropy
@pytest.mark.parametrize("V, tied", [(256, False), (245, False), (245, True)])
def test_cross_entropy_matches_reference(V, tied):
    """Value and gradients with respect to the hidden states and the head,
    at one chunk (V 256) and at 5 (V 245, ``xent_chunks``'s choice), tied
    or not; a mask drops some positions."""
    from repro_torch.models.model import xent_chunks

    n_chunks = xent_chunks(dataclasses.replace(get_config(ARCHS[0]), vocab=V))
    assert n_chunks == (1 if V % 16 == 0 else 5)
    rng = np.random.default_rng(V + tied)
    d = 64
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    w = (rng.standard_normal((V, d) if tied else (d, V)) / 8).astype(
        np.float32)
    labels = rng.integers(0, V, (2, 12)).astype(np.int32)
    mask = rng.random((2, 12)) > 0.2

    def jfn(x, w):
        return jcross_entropy(w, x, jnp.asarray(labels), jnp.asarray(mask),
                              tied, n_chunks=n_chunks)

    xj, wj = jnp.asarray(x).astype(jnp.bfloat16), \
        jnp.asarray(w).astype(jnp.bfloat16)
    jval, (jgx, jgw) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)),
                               **_STRICT)(xj, wj)
    xt = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wt = torch.from_numpy(w).bfloat16().requires_grad_(True)
    val = cross_entropy(wt, xt, torch.from_numpy(labels).long(),
                        torch.from_numpy(mask), tied, n_chunks=n_chunks)
    gx, gw = torch.autograd.grad(val, (xt, wt))
    assert abs(float(val.detach()) - float(jval)) <= LOSS_ATOL
    _grads_close(gx, jgx, "dx")
    _grads_close(gw, jgw, "dw")


# ------------------------------------------------------------------- loss
def test_loss_and_every_gradient_leaf_match_reference(arch):
    """The loss and the gradient of every leaf of the bf16 compute copy;
    the port's remat on (the smoke configs' default) equals remat off bit
    for bit."""
    jcfg, tree, cfg, grad_fn = arch
    toks = _tokens(cfg, 0)
    (jl, jm), jg = grad_fn(_cast_bf16(tree), {"tokens": jnp.asarray(toks)})
    model = _compute_copy(cfg, tree)
    params = [p for _, p in model.named_parameters()]
    batch = {"tokens": torch.from_numpy(toks)}
    assert cfg.remat
    loss, metrics = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params)
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_ATOL
    assert abs(float(metrics["ce"].detach()) - float(jm["ce"])) <= LOSS_ATOL
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    for (name, _, path, j), g in zip(_reference_leaves(cfg, model), grads):
        assert g.dtype == dict(model.named_parameters())[name].dtype
        _grads_close(g, _leaf(jg, path, j), name)
    loss_off, _ = loss_fn(model, batch, remat=False)
    grads_off = torch.autograd.grad(loss_off, params)
    assert torch.equal(loss, loss_off)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_off))


# -------------------------------------------------------------- optimizer
def test_adamw_and_cosine_lr_match_reference():
    """Four AdamW steps on identical float32 gradients, at the cosine
    schedule's rates: masters and moments within 1e-6 relative (float32
    elementwise arithmetic in the same order; only ``pow``/``sqrt``/
    ``cos`` may differ by an ulp), and the global norm summed over leaves
    in another order."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 6)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    sched = LRSchedule(base=1e-2, warmup=2, total=10, min_ratio=0.1)
    jsched = JLRSchedule(*sched)
    jstate = jadamw_init({k: jnp.asarray(v) for k, v in params.items()})
    state = adamw_init({k: torch.from_numpy(v.copy())
                        for k, v in params.items()})
    jupdate, jlr_of = jax.jit(jadamw_update), jax.jit(jcosine_lr,
                                                      static_argnums=0)
    for step in range(4):
        scale = 0.3 if step % 2 else 5.0  # clipped and not
        g = {k: (scale * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
        jlr = jlr_of(jsched, jstate.step)
        lr = cosine_lr(sched, state.step)
        np.testing.assert_allclose(float(lr), float(jlr), rtol=1e-6)
        jstate = jupdate(jstate, {k: jnp.asarray(v) for k, v in g.items()},
                         jlr)
        state = adamw_update(state, {k: torch.from_numpy(v)
                                     for k, v in g.items()}, lr)
        assert int(state.step) == int(jstate.step) == step + 1
        for part in ("params", "m", "v"):
            for k in shapes:
                np.testing.assert_allclose(
                    getattr(state, part)[k].numpy(),
                    np.asarray(getattr(jstate, part)[k]), rtol=1e-6,
                    atol=1e-7)
    for s in (0, 1, 5, 9, 20):
        np.testing.assert_allclose(
            float(cosine_lr(sched, torch.tensor(s, dtype=torch.int32))),
            float(jlr_of(jsched, jnp.int32(s))), rtol=1e-6)


# ------------------------------------------------------------- train step
#: masters after 3 steps. AdamW moves an element by ~lr·sign(g) early on,
#: whatever |g|, so an element whose bf16 gradient is near 0 may take the
#: other sign on the two sides: at most 2·Σlr for such an element, and the
#: mean difference a small share of Σlr.
STEP_MEAN_REL = 2.0 ** -6
TRAIN_TCFG = dict(steps=3, lr=dict(base=3e-3, warmup=2, total=10))


_MODES = {"one_batch": {}, "microbatch_2": dict(microbatch=2),
          "compress_grads": dict(compress_grads=True)}


@pytest.fixture(scope="module")
def jsteps():
    """The reference's train step at mistral-nemo-12b@smoke for each mode,
    each compiled once for the module."""
    jcfg = jget_config(ARCHS[0])
    lr = JLRSchedule(**TRAIN_TCFG["lr"])
    return {mode: jax.jit(jmake_train_step(jcfg, JTrainConfig(
        steps=3, lr=lr, **extra)), **_STRICT)
        for mode, extra in _MODES.items()}


def _masters_close(cfg, model, state, jstate, total_lr: float) -> None:
    jp = jax.tree.map(np.asarray, jstate.params)
    diffs = []
    for name, _, path, j in _reference_leaves(cfg, model):
        d = np.abs(state.params[name].numpy() - _leaf(jp, path, j))
        assert d.max() <= 2 * total_lr + 1e-6, (name, d.max())
        diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= STEP_MEAN_REL * total_lr


@pytest.mark.parametrize("mode", ["one_batch", "microbatch_2",
                                  "compress_grads"])
def test_train_step_matches_reference(mode, jsteps):
    """3 steps of ``make_train_step`` (B 4, S 32, mistral-nemo-12b@smoke)
    from the same masters and tokens: the losses within ``LOSS_ATOL`` per
    step (plus the drift of the masters), the masters as
    ``_masters_close`` bounds them; with ``compress_grads`` the error
    feedback residuals too (int8 rounding of nearly equal values)."""
    jcfg, cfg = jget_config(ARCHS[0]), get_config(ARCHS[0])
    tree = _ref_params(jcfg, 1)
    tcfg = TrainConfig(steps=3, lr=LRSchedule(**TRAIN_TCFG["lr"]),
                       **_MODES[mode])
    jstep = jsteps[mode]
    step = make_train_step(cfg, tcfg, device="cpu")
    jstate = jadamw_init(jax.tree.map(jnp.asarray, tree))
    state = train_state_from_numpy(
        cfg, {"step": 0, "params": tree,
              "m": jax.tree.map(np.zeros_like, tree),
              "v": jax.tree.map(np.zeros_like, tree)}, device="cpu")
    jef = jinit_ef(jstate.params) if tcfg.compress_grads else \
        jax.tree.map(lambda _: jnp.zeros((), jnp.float32), jstate.params)
    ef = init_error_feedback(state.params) if tcfg.compress_grads else None
    total_lr = 0.0
    model = LM(cfg, "cpu")  # names only
    for k in range(3):
        toks = _tokens(cfg, 10 + k)
        jstate, jef, jm = jstep(jstate, {"tokens": jnp.asarray(toks)}, jef)
        state, ef, m = step(state, {"tokens": torch.from_numpy(toks)}, ef)
        total_lr += float(jm["lr"])
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= \
            LOSS_ATOL + 4 * total_lr, (k, float(m["loss"]), float(jm["loss"]))
        _masters_close(cfg, model, state, jstate, total_lr)
    assert int(state.step) == int(jstate.step) == 3
    if tcfg.compress_grads:
        jr = jax.tree.map(np.asarray, jef)
        for name, _, path, j in _reference_leaves(cfg, model):
            ref = _leaf(jr, path, j)
            # a residual is bounded by half a quantization step of its
            # block; values that round to the other int8 step on the two
            # sides differ by one step (scale <= max|g| / 127)
            assert np.abs(ef[name].numpy() - ref).max() <= \
                np.abs(ref).max() * 2.5 + 1e-6


def test_state_from_reference_checkpoint_takes_the_same_step(tmp_path,
                                                            jsteps):
    """A reference state after one step, saved by ``repro.train.save``,
    read back from its ``arrays.npz`` with ``reference_checkpoint_tree``
    and ``train_state_from_numpy``: every master and moment equal to the
    reference's, the step equal; then one more step on each side agrees as
    ``test_train_step_matches_reference`` bounds it."""
    jcfg, cfg = jget_config(ARCHS[0]), get_config(ARCHS[0])
    params = jax.tree.map(jnp.asarray, _ref_params(jcfg, 2))
    lr = TRAIN_TCFG["lr"]
    jstep = jsteps["one_batch"]
    jef = jax.tree.map(lambda _: jnp.zeros((), jnp.float32), params)
    jstate, jef, jm0 = jstep(jadamw_init(params),
                             {"tokens": jnp.asarray(_tokens(cfg, 20))}, jef)
    jsave(str(tmp_path), 1, jstate)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as arrays:
        state = train_state_from_numpy(cfg, reference_checkpoint_tree(arrays),
                                       device="cpu")
    model = LM(cfg, "cpu")
    assert int(state.step) == 1
    for part in ("params", "m", "v"):
        ref = jax.tree.map(np.asarray, getattr(jstate, part))
        for name, _, path, j in _reference_leaves(cfg, model):
            assert np.array_equal(getattr(state, part)[name].numpy(),
                                  _leaf(ref, path, j)), (part, name)
    toks = _tokens(cfg, 21)
    jstate, _, jm = jstep(jstate, {"tokens": jnp.asarray(toks)}, jef)
    step = make_train_step(cfg, TrainConfig(lr=LRSchedule(**lr)), "cpu")
    state, _, m = step(state, {"tokens": torch.from_numpy(toks)}, None)
    total_lr = float(jm0["lr"]) + float(jm["lr"])
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    _masters_close(cfg, model, state, jstate, float(jm["lr"]))
    assert total_lr > 0


# ------------------------------------------------ compression and the data
def test_quantize_payloads_equal_reference():
    """int8 payloads and float32 scales bit for bit (the same float32
    max, division and round-half-to-even), the residuals within float32
    rounding, at a ragged size (300: a padded block) and a matrix."""
    rng = np.random.default_rng(5)
    g = {"w": (rng.standard_normal(300) * 5).astype(np.float32),
         "m": rng.standard_normal((64, 70)).astype(np.float32)}
    e = {k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
         for k, v in g.items()}
    jpay, jres = jquantize_tree({k: jnp.asarray(v) for k, v in g.items()},
                                {k: jnp.asarray(v) for k, v in e.items()})
    pay, res = quantize_tree({k: torch.from_numpy(v) for k, v in g.items()},
                             {k: torch.from_numpy(v) for k, v in e.items()})
    for k in g:
        assert pay.q[k].dtype == torch.int8
        assert np.array_equal(pay.q[k].numpy(), np.asarray(jpay.q[k]))
        assert np.array_equal(pay.scale[k].numpy(), np.asarray(jpay.scale[k]))
        np.testing.assert_allclose(res[k].numpy(), np.asarray(jres[k]),
                                   rtol=0, atol=1e-6)


def test_bigram_entropy_equals_reference():
    """Equal at the default four successors (every config's); at seven the
    float32 sum of the terms runs in another order: within 2 ulps."""
    for vocab in (256, 32064, 49152):
        assert bigram_entropy(DataConfig(vocab, 8, 2)) == \
            jbigram_entropy(JDataConfig(vocab, 8, 2))
    assert bigram_entropy(DataConfig(100, 8, 2, branch=7)) == pytest.approx(
        jbigram_entropy(JDataConfig(100, 8, 2, branch=7)), rel=2.5e-7)
