"""Training of the vision, MLA and MoE families on the CPU: the port's
``loss_fn`` and train step against the live JAX package at
``pixtral-12b@smoke`` (the dense backbone, 16 patch slots),
``minicpm3-4b@smoke`` (MLA with a q LoRA, q·k 16 + 8 rope, v 16),
``phi3.5-moe-42b-a6.6b@smoke`` (GQA, 4 experts, top-2) and
``deepseek-v2-lite-16b@smoke`` (MLA without a q LoRA, a dense lead layer,
then 4 experts top-2 and a shared one), on the same numpy tokens and the
same weights (the reference's ``init`` tree, loaded with ``convert``).

- ``loss``, ``ce``, ``aux`` and every gradient leaf of the bf16 compute
  copy against the reference's ``value_and_grad(loss_fn)``, with
  ``tests/test_torch_train.py``'s tolerances (stated below with their
  reasons); pixtral at S 32 over its 16 patch slots, with patch
  embeddings and without (the slots masked out of ``ce`` either way).
- The MoE configs' aux is the sum of their MoE layers' balance losses,
  nonzero, at ``AUX_RTOL``; each MoE layer's expert choices equal the
  reference's, recomputed op by op from the reference's own layer input
  (``jax.debug.callback`` hands the input of each of its ``moe_apply``
  calls to the host), as ``tests/test_torch_moe.py`` does: XLA's fused
  router softmax rounds otherwise.
- ``remat`` on (the smoke configs' default) equals remat off bit for bit;
  under remat the ``routing=`` hook sees each MoE layer's router again in
  the backward (the layer index tells the calls apart), with the
  forward's choices.
- One ``make_train_step`` step at deepseek-v2-lite-16b@smoke against the
  reference's, as ``tests/test_torch_train.py`` bounds it.
- ``frames`` and ``images`` that a config cannot take are refused.

The reference is compiled with XLA's excess precision off (``_STRICT``),
so its bf16 steps round as each op alone rounds.
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
from repro.models import init as jinit
from repro.models import loss_fn as jloss_fn
from repro.models import moe as jmoe
from repro.train import LRSchedule as JLRSchedule
from repro.train import TrainConfig as JTrainConfig
from repro.train import adamw_init as jadamw_init
from repro.train import make_train_step as jmake_train_step
from repro.train.loop import _cast_bf16
from repro_torch.configs import get_config
from repro_torch.convert import (_leaf, _reference_leaves,
                                 lm_params_from_numpy, train_state_from_numpy)
from repro_torch.models import LM, loss_fn
from repro_torch.models import moe as tmoe
from repro_torch.train import LRSchedule, TrainConfig, make_train_step

_STRICT = dict(compiler_options={"xla_allow_excess_precision": False})
B, S = 4, 32
#: (arch, with patch embeddings)
CASES = [("pixtral-12b@smoke", True), ("pixtral-12b@smoke", False),
         ("minicpm3-4b@smoke", False), ("phi3.5-moe-42b-a6.6b@smoke", False),
         ("deepseek-v2-lite-16b@smoke", False)]
IDS = ["pixtral-images", "pixtral-tokens", "minicpm3", "phi3.5-moe",
       "deepseek"]
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b@smoke", "deepseek-v2-lite-16b@smoke"]

#: ``tests/test_torch_train.py``'s: the mean of B·S float32 cross
#: entropies of bf16 logits, where a one-ulp flip of a logit moves the
#: mean by up to ~1.2e-4; a wrong mask, label shift or head moves it by
#: O(0.1) (measured here: at most 2.9e-4, deepseek)
LOSS_ATOL = 1e-3
#: the balance loss E·Σ_e frac_e·mean prob_e: with equal expert choices
#: (checked below) it differs only through the float32 probabilities,
#: whose router inputs may carry one-ulp bf16 flips from upstream
#: (measured: 2.5e-6 relative, deepseek); a constant 0, a layer left out
#: or another layer's aux moves it by O(1)
AUX_RTOL = 1e-4
#: ``tests/test_torch_train.py``'s: each element within 2^-5 of the leaf's
#: max |value|, the mean difference within 2^-6 of its mean |value|
#: (sums in another order, one-ulp bf16 flips carried through two layers;
#: measured here at most 0.014 / 0.012 of them); a wrong mask, head,
#: position, gate or slot moves gradients by O(1)
GRAD_ATOL_REL, GRAD_MEAN_REL = 2.0 ** -5, 2.0 ** -6
#: ce against the same masked mean taken by hand from the float32 logits
#: (a sum in another order over B·(S - n_patches) = 64 terms)
MASK_ATOL = 1e-5
#: ``tests/test_torch_train.py``'s bound on the masters' mean difference
#: after a step, as a share of the step's learning rate
STEP_MEAN_REL = 2.0 ** -6

_NORMS = {"ln1", "ln2", "final_ln", "q_norm", "k_norm", "kv_norm"}


def _ref_params(jcfg, seed: int) -> dict:
    """The reference's ``init`` tree (shapes from ``jax.eval_shape``, so
    nothing of ``init`` is compiled), drawn with numpy: norm scales 1 as
    ``init`` sets them, every other leaf N(0, 1)/√d_model."""
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
    assert diff.max() <= GRAD_ATOL_REL * np.abs(want).max(), \
        (what, diff.max(), np.abs(want).max())
    assert diff.mean() <= GRAD_MEAN_REL * np.abs(want).mean(), \
        (what, diff.mean(), np.abs(want).mean())


def _batch(cfg, seed: int, images: bool) -> dict:
    """numpy tokens [B, S+1] and, with ``images``, patch embeddings [B,
    n_patches, d] (O(1), as the reference's stub feeds them)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)}
    if images:
        out["images"] = (0.5 * rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return out


def _compute_copy(cfg, tree) -> LM:
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    return model


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """The reference's loss, its aux and its gradients (jitted
    ``value_and_grad``) at one case, and the port's inputs."""
    arch, images = request.param
    jcfg, cfg = jget_config(arch), get_config(arch)
    tree = _ref_params(jcfg, 0)
    batch = _batch(cfg, 1, images)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True), **_STRICT)
    (jl, jm), jg = grad_fn(_cast_bf16(tree),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(cfg=cfg, tree=tree, batch=batch, loss=float(jl),
                ce=float(jm["ce"]), aux=float(jm["aux"]), grads=jg)


def test_loss_and_every_gradient_leaf_match_reference(case):
    """loss, ce, aux and every leaf's gradient; aux nonzero exactly for the
    MoE configs; remat on equal to remat off bit for bit."""
    cfg = case["cfg"]
    model = _compute_copy(cfg, case["tree"])
    params = [p for _, p in model.named_parameters()]
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    assert cfg.remat
    loss, metrics = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, params)
    assert abs(float(loss.detach()) - case["loss"]) <= LOSS_ATOL
    assert abs(float(metrics["ce"].detach()) - case["ce"]) <= LOSS_ATOL
    aux = float(metrics["aux"].detach())
    if cfg.n_experts:
        assert case["aux"] > 0.5
        assert abs(aux - case["aux"]) <= AUX_RTOL * case["aux"], \
            (aux, case["aux"])
    else:
        assert aux == case["aux"] == 0.0
    leaves = _reference_leaves(cfg, model)
    # every leaf of the reference's tree has its parameters in the port
    assert {path for _, _, path, _ in leaves} == {
        ".".join(k.key for k in kp) for kp, _ in
        jax.tree_util.tree_flatten_with_path(case["grads"])[0]}
    for (name, _, path, j), g in zip(leaves, grads):
        assert g.dtype == dict(model.named_parameters())[name].dtype
        _grads_close(g, _leaf(case["grads"], path, j), name)
    loss_off, metrics_off = loss_fn(model, batch, remat=False)
    grads_off = torch.autograd.grad(loss_off, params)
    assert torch.equal(loss, loss_off)
    assert torch.equal(metrics["aux"], metrics_off["aux"])
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_off))


@pytest.mark.parametrize("case", CASES[:2], ids=IDS[:2], indirect=True)
def test_vision_loss_masks_the_patch_slots(case):
    """ce is the mean cross entropy of the positions from ``n_patches`` on,
    each from the float32 logits of the trunk's hidden states, within
    float32 rounding (``MASK_ATOL``); the mean over every position is
    further off than that."""
    from repro_torch.models.model import _loss_trunk

    cfg = case["cfg"]
    assert cfg.frontend == "vision"
    model = _compute_copy(cfg, case["tree"])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    toks = batch["tokens"].long()
    with torch.no_grad():
        ce = float(loss_fn(model, batch)[1]["ce"])
        x = _loss_trunk(model, toks[:, :-1], batch.get("images"), None,
                        None, False)[0]
        logits = (x @ model.head).float()
        each = torch.nn.functional.cross_entropy(
            logits.transpose(1, 2), toks[:, 1:], reduction="none")
    masked = float(each[:, cfg.n_patches:].mean())
    assert abs(ce - masked) <= MASK_ATOL, (ce, masked)
    assert abs(ce - float(each.mean())) > 10 * MASK_ATOL


def _reference_choices(jcfg, tree, tokens) -> list[np.ndarray]:
    """Each MoE layer's expert choices in the reference's forward, in layer
    order: its ``moe_apply`` is wrapped (for this call only) to hand its
    input and router to the host, where the choices are recomputed op by
    op, as ``repro/models/moe.py`` computes them."""
    seen = []
    orig = jmoe.moe_apply

    def record(p, cfg, x):
        jax.debug.callback(lambda xv, rv: seen.append((xv, rv)), x,
                           p["router"], ordered=True)
        return orig(p, cfg, x)

    jmoe.moe_apply = record
    try:
        jax.jit(lambda p, b: jloss_fn(p, jcfg, b, remat=False), **_STRICT)(
            _cast_bf16(tree), {"tokens": jnp.asarray(tokens)})
        jax.effects_barrier()
    finally:
        jmoe.moe_apply = orig
    out = []
    for xv, rv in seen:
        xt = jnp.asarray(xv).reshape(-1, xv.shape[-1])
        probs = jax.nn.softmax((xt @ jnp.asarray(rv).astype(xt.dtype))
                               .astype(jnp.float32), axis=-1)
        out.append(np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1]))
    return out


def _layer_recorder() -> tuple:
    """A ``routing=`` hook that routes as the model does, and the choices
    it made for each layer, call by call."""
    calls: dict[int, list] = {}

    def routing(layer, probs, k):
        calls.setdefault(layer, []).append(tmoe.route(probs, k))
        return calls[layer][-1]

    return routing, calls


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_choices_equal_reference_and_replay_under_remat(arch):
    """Each MoE layer's expert choices in the port's loss equal the
    reference's; under remat each layer's hook is called again in the
    backward with the same choices, once without remat; replaying the
    recorded choices layer by layer gives the same loss and gradients."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    tree = _ref_params(jcfg, 0)
    tokens = _batch(cfg, 1, False)["tokens"]
    want = _reference_choices(jcfg, tree, tokens)
    moe_layers = [i for i in range(cfg.n_layers)
                  if i >= cfg.first_dense_layers]
    assert len(want) == len(moe_layers) > 0
    model = _compute_copy(cfg, tree)
    params = list(model.parameters())
    batch = {"tokens": torch.from_numpy(tokens)}
    hook, calls = _layer_recorder()
    loss, _ = loss_fn(model, batch, routing=hook)
    grads = torch.autograd.grad(loss, params)
    assert sorted(calls) == moe_layers
    for i, w in zip(moe_layers, want):
        fwd, again = calls[i]             # the forward, then remat's rerun
        assert np.array_equal(fwd.numpy(), w), i
        assert torch.equal(fwd, again), i
    hook_off, calls_off = _layer_recorder()
    with torch.no_grad():
        loss_fn(model, batch, remat=False, routing=hook_off)
    assert {i: len(c) for i, c in calls_off.items()} == \
        {i: 1 for i in moe_layers}

    def replay(layer, probs, k):
        return calls[layer][0]

    loss_r, _ = loss_fn(model, batch, routing=replay)
    grads_r = torch.autograd.grad(loss_r, params)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))


def test_train_step_matches_reference_deepseek():
    """One ``make_train_step`` step (B 4, S 32) at deepseek-v2-lite-16b@smoke
    from the same masters and tokens: the loss within ``LOSS_ATOL``, the
    masters within 2·lr each (an element whose bf16 gradient is near 0 may
    take the other sign under AdamW) and their mean difference within
    ``STEP_MEAN_REL``·lr."""
    arch = "deepseek-v2-lite-16b@smoke"
    jcfg, cfg = jget_config(arch), get_config(arch)
    tree = _ref_params(jcfg, 2)
    lr = dict(base=3e-3, warmup=2, total=10)
    jstep = jax.jit(jmake_train_step(jcfg, JTrainConfig(
        steps=1, lr=JLRSchedule(**lr))), **_STRICT)
    step = make_train_step(cfg, TrainConfig(steps=1, lr=LRSchedule(**lr)),
                           device="cpu")
    jstate = jadamw_init(jax.tree.map(jnp.asarray, tree))
    state = train_state_from_numpy(
        cfg, {"step": 0, "params": tree,
              "m": jax.tree.map(np.zeros_like, tree),
              "v": jax.tree.map(np.zeros_like, tree)}, device="cpu")
    toks = _batch(cfg, 3, False)["tokens"]
    jef = jax.tree.map(lambda _: jnp.zeros((), jnp.float32), jstate.params)
    jstate, _, jm = jstep(jstate, {"tokens": jnp.asarray(toks)}, jef)
    state, _, m = step(state, {"tokens": torch.from_numpy(toks)}, None)
    step_lr = float(jm["lr"])
    assert step_lr > 0
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_ATOL
    assert abs(float(m["aux"]) - float(jm["aux"])) <= \
        AUX_RTOL * float(jm["aux"])
    jp = jax.tree.map(np.asarray, jstate.params)
    diffs = []
    for name, _, path, j in _reference_leaves(cfg, LM(cfg, "cpu")):
        d = np.abs(state.params[name].numpy() - _leaf(jp, path, j))
        assert d.max() <= 2 * step_lr + 1e-6, (name, d.max())
        diffs.append(d.ravel())
    assert np.concatenate(diffs).mean() <= STEP_MEAN_REL * step_lr
    assert int(state.step) == int(jstate.step) == 1


def test_inputs_a_config_cannot_take_are_refused():
    """``images`` to a config without a vision frontend, images too short
    or of another width, and ``frames`` to a decoder-only config raise."""
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 33)))
    vlm = LM(get_config("pixtral-12b@smoke"), "cpu")
    mla = LM(get_config("minicpm3-4b@smoke"), "cpu")
    d = vlm.cfg.d_model
    with pytest.raises(ValueError, match="no vision frontend"):
        loss_fn(mla, {"tokens": toks, "images": torch.zeros(2, 16, d)})
    with pytest.raises(ValueError, match="images must be"):
        loss_fn(vlm, {"tokens": toks, "images": torch.zeros(2, 8, d)})
    with pytest.raises(ValueError, match="images must be"):
        loss_fn(vlm, {"tokens": toks, "images": torch.zeros(2, 16, d + 1)})
    with pytest.raises(ValueError, match="no encoder for frames"):
        loss_fn(vlm, {"tokens": toks, "frames": torch.zeros(2, 16, d)})
