"""The plain reference against the program at its smoke-twin sizes on the
CPU, both in float32 (the program's embedding lookup made float32, so its
whole forward follows): the prefill's and every teacher-forced decode
step's logits, the training loss and its gradients, and one AdamW step.
A reference that departs from the program's semantics (rope layout, head
grouping, MLA, the MoE layer's routing, capacity and drops per call, the
balance loss, the optimizer) fails these by orders of magnitude."""
import dataclasses

import pytest
import torch

import repro_torch.models.model as model_mod
from portbench import weights
from portbench.reference.common import strict_float32
from portbench.reference.mla import mla, mla_decode
from portbench.reference.model import loss as ref_loss
from portbench.reference.model import served_logits
from portbench.sizes import Sizes
from repro_torch.configs import get_config
from repro_torch.models import LM, decode_step, init_cache, loss_fn, prefill
from repro_torch.serve import Engine, ServeConfig
from repro_torch.train.optimizer import adamw_init, adamw_update

from smoke import DEEPSEEK, NEMO

SEED = 2**32 + 77


@pytest.fixture
def float32_program(monkeypatch):
    strict_float32()
    monkeypatch.setattr(model_mod, "embed",
                        lambda table, tokens, dtype: table.float()[tokens])


def _model(config, sizes, capacity=None):
    cfg = get_config(config["registry"])
    if capacity is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    m = LM(cfg, "cpu")
    weights.fill_named_(dict(m.named_parameters()), sizes, SEED)
    for p in m.parameters():
        p.data = p.data.float()
    return cfg, m


CASES = [("nemo", NEMO, None), ("deepseek", DEEPSEEK, None),
         ("deepseek-drops", DEEPSEEK, 0.5)]


@pytest.mark.parametrize("name,config,capacity", CASES, ids=[c[0] for c in CASES])
def test_served_logits_match_program(float32_program, name, config, capacity):
    conf = dict(config, **({} if capacity is None else {"capacity_factor": capacity}))
    s = Sizes.from_config(name, conf)
    cfg, m = _model(config, s, capacity)
    B, S0, n = 3, 20, 4
    prompt = weights.tokens("cpu", SEED, "p", 0, (B, S0), s.vocab)
    served = weights.tokens("cpu", SEED, "s", 0, (B, n), s.vocab)
    cache, logits = prefill(m, prompt)
    dec = init_cache(cfg, B, S0 + n, dtype=torch.float32, device="cpu")
    dec = Engine(cfg, m, ServeConfig(max_len=S0 + n))._merge_caches(dec, cache, S0)
    got = [logits]
    for i in range(n - 1):
        dec, logits = decode_step(m, dec, served[:, i].to(torch.int32), S0 + i)
        got.append(logits)
    got = torch.stack(got, dim=1)
    weight = lambda nm: weights.leaf(s, SEED, nm, torch.bfloat16, "cpu").float()  # noqa: E731
    ref = served_logits(s, weight, torch.cat([prompt, served[:, :-1]], 1), S0)
    assert ref.shape == got.shape
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_mla_absorbed_decode_equals_expanded():
    strict_float32()
    s = Sizes.from_config("ds", DEEPSEEK)
    g = torch.Generator().manual_seed(3)
    w = {k: torch.randn(shape, generator=g) / (shape[0] ** 0.5)
         for k, (shape, _) in s.leaves().items() if k.startswith("layers.0.attn.")}
    w = {k[len("layers.0.attn."):]: v for k, v in w.items()}
    w["kv_norm"] = torch.ones(s.kv_lora)
    x = torch.randn(2, 9, s.d, generator=g)
    full = mla(x, w, s, torch.arange(9))
    lat = torch.zeros(2, 0, s.kv_lora)
    kr = torch.zeros(2, 0, s.rope_dim)
    for p in range(9):
        y, lat, kr = mla_decode(x[:, p:p + 1], w, s, p, lat, kr)
        torch.testing.assert_close(y[:, 0], full[:, p], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,config", [("nemo", NEMO), ("deepseek", DEEPSEEK)])
def test_training_loss_gradients_and_adamw_match_program(float32_program, name, config):
    s = Sizes.from_config(name, config)
    cfg, m = _model(config, s)
    for p in m.parameters():
        p.requires_grad_(True)
    tokens = weights.tokens("cpu", SEED, "t", 0, (2, 17), s.vocab)
    loss, _ = loss_fn(m, {"tokens": tokens}, remat=False)
    names = [nm for nm, _ in m.named_parameters()]
    g_prog = torch.autograd.grad(loss, list(m.parameters()))
    params = {nm: weights.leaf(s, SEED, nm, torch.bfloat16, "cpu").float()
              .requires_grad_(True) for nm in names}
    lref = ref_loss(s, params, tokens)
    g_ref = torch.autograd.grad(lref, list(params.values()))
    torch.testing.assert_close(loss, lref, rtol=1e-5, atol=1e-5)
    for nm, a, b in zip(names, g_prog, g_ref):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5, msg=nm)
    # one AdamW step each, from the same masters and gradients
    from portbench.reference.adamw import adamw_step, lr_at
    grads = dict(zip(names, g_ref))
    masters = {nm: p.detach().clone() for nm, p in params.items()}
    state = adamw_init({nm: p.clone() for nm, p in masters.items()})
    lr = lr_at(0, 3e-4, 100, 10000, 0.1)
    adamw_update(state, grads, torch.tensor(lr), wd=0.1, clip=1.0)
    m_ = {nm: torch.zeros_like(p) for nm, p in masters.items()}
    v_ = {nm: torch.zeros_like(p) for nm, p in masters.items()}
    adamw_step(masters, grads, m_, v_, 0, lr, 0.9, 0.95, 1e-8, 0.1, 1.0)
    for nm in names:
        torch.testing.assert_close(state.params[nm], masters[nm], rtol=1e-6, atol=1e-7)
