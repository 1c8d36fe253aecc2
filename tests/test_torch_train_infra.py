"""Training infrastructure of the port on the CPU, the twins of
``tests/test_train_infra.py``: data determinism and host slicing, the
bigram stream, checkpoints (round trip, ``LATEST``, shape checks, the
asynchronous writer, restore onto a device), the loss falling on the
bigram stream toward its floor, a preempted run resumed from its
checkpoint equal to an uninterrupted one bit for bit, the int8 round trip
and its error feedback, compressed training, ``check_trainable``
refusing SSM, the hybrid and audio and accepting the dense (GQA, MLA),
vision and MoE families on either device, and the launcher at MoE and MLA
smoke configs. The port
against the live JAX package is ``tests/test_torch_train.py``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import init, loss_fn, prefill
from repro_torch.models.model import check_trainable
from repro_torch.parallel import (dequantize_tree, ef_update,
                                  init_error_feedback, quantize_tree)
from repro_torch.train import (AsyncCheckpointer, DataConfig, LRSchedule,
                               TrainConfig, adamw_init, bigram_entropy,
                               init_params, latest_step, make_batch,
                               make_train_step, restore, save, train)
from repro_torch.train.data import _succ_table

CFG = get_config("mistral-nemo-12b", smoke=True)
DCFG = DataConfig(vocab=CFG.vocab, seq_len=24, global_batch=8, seed=0)


def _init_fn(seed: int = 0):
    return lambda: init_params(CFG, torch.Generator().manual_seed(seed),
                               "cpu")


# ------------------------------------------------------------------ data
def test_data_deterministic_and_distinct():
    b1, b2, b3 = (make_batch(DCFG, s)["tokens"] for s in (3, 3, 4))
    assert torch.equal(b1, b2)
    assert not torch.equal(b1, b3)
    assert b1.shape == (8, 25)
    assert int(b1.min()) >= 0 and int(b1.max()) < CFG.vocab


def test_data_host_slicing():
    full = [make_batch(DCFG, 5, host_id=h, n_hosts=4)["tokens"]
            for h in range(4)]
    assert all(t.shape == (2, 25) for t in full)
    assert not torch.equal(full[0], full[1])  # hosts draw their own slices
    with pytest.raises(ValueError):
        make_batch(DCFG, 0, n_hosts=3)


def test_data_follows_bigram():
    dc = dataclasses.replace(DCFG, seq_len=64)
    toks = make_batch(dc, 0)["tokens"].numpy()
    succ = _succ_table(dc).numpy()
    assert all(b in succ[a] for row in toks for a, b in zip(row[:-1], row[1:]))
    # every successor slot is drawn, the first (weight 0.48) most often
    slot = np.array([list(succ[a]).index(b) for row in toks
                     for a, b in zip(row[:-1], row[1:])])
    counts = np.bincount(slot, minlength=dc.branch)
    assert counts.argmax() == 0 and (counts > 0).all()
    assert bigram_entropy(dc) == pytest.approx(1.2424577, rel=1e-6)


# ------------------------------------------------------------ checkpoints
def test_checkpoint_roundtrip_and_latest(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.full((4,), 1.5, dtype=torch.bfloat16)},
            "n": np.arange(3, dtype=np.int32)}
    save(str(tmp_path), 7, tree, extra={"note": "x"})
    save(str(tmp_path), 9, tree)
    assert latest_step(str(tmp_path)) == 9
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["LATEST", "step_00000007", "step_00000009"]
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as arrays:
        assert arrays["b/c"].dtype == np.float32  # bf16 written as float32
    got, manifest = restore(str(tmp_path), tree, step=7)
    assert manifest["extra"]["note"] == "x" and manifest["step"] == 7
    assert torch.equal(got["a"], tree["a"])
    assert got["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
    assert np.array_equal(got["n"], tree["n"])


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    save(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        restore(str(tmp_path), {"a": torch.zeros((3, 3))})
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), {"a": torch.zeros((2, 2))})


def test_async_checkpointer_and_train_state(tmp_path):
    """The writer snapshots before the caller mutates; a ``TrainState``
    restores field by field, onto the device asked for."""
    state = adamw_init({"w": torch.ones((8, 8)), "b": torch.zeros((8,))})
    ck = AsyncCheckpointer(str(tmp_path))
    ck.submit(5, state)
    state.params["w"].add_(1.0)  # after the snapshot
    ck.wait()
    assert latest_step(str(tmp_path)) == 5
    got, _ = restore(str(tmp_path), state, device="cpu")
    assert type(got) is type(state)
    assert torch.equal(got.params["w"], torch.ones((8, 8)))
    assert got.step.dtype == torch.int32 and int(got.step) == 0


# ------------------------------------------------------------ train loop
def test_loss_decreases_on_bigram():
    tcfg = TrainConfig(steps=40, log_every=5,
                       lr=LRSchedule(base=3e-3, warmup=5, total=40))
    _, hist = train(CFG, tcfg, DCFG, _init_fn(), verbose=False, device="cpu")
    first, last = hist[0]["loss"], hist[-1]["loss"]
    assert [h["step"] for h in hist] == list(range(5, 41, 5))
    assert last < first - 0.2
    assert last > bigram_entropy(DCFG) - 0.05  # cannot beat the floor


def test_preempt_resume_bit_exact(tmp_path):
    d = str(tmp_path)
    tcfg = TrainConfig(steps=16, ckpt_dir=d, ckpt_every=4, log_every=16)
    train(CFG, tcfg, DCFG, _init_fn(), preempt_after=8, verbose=False,
          device="cpu")
    assert latest_step(d) == 8
    s_resumed, _ = train(CFG, tcfg, DCFG, _init_fn(), verbose=False,
                         device="cpu")
    assert latest_step(d) == 16
    s_straight, _ = train(CFG, dataclasses.replace(tcfg, ckpt_dir=None),
                          DCFG, _init_fn(), verbose=False, device="cpu")
    assert int(s_resumed.step) == int(s_straight.step) == 16
    for part in ("params", "m", "v"):
        a, b = getattr(s_resumed, part), getattr(s_straight, part)
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_step_leaves_serving_models_alone():
    """The compute copy is the step's own: a serving model's parameters
    keep ``requires_grad=False`` and its prefill builds no graph."""
    step = make_train_step(CFG, TrainConfig(), device="cpu")
    model = init(CFG, torch.Generator().manual_seed(0), "cpu")
    state = adamw_init(init_params(CFG, torch.Generator().manual_seed(1),
                                   "cpu"))
    step(state, make_batch(DCFG, 0), None)
    assert not any(p.requires_grad for p in model.parameters())
    _, logits = prefill(model, make_batch(DCFG, 0)["tokens"][:, :8])
    assert not logits.requires_grad


# ---------------------------------------------------- gradient compression
def test_quantize_roundtrip_bounded():
    g = {"w": torch.randn(300, generator=torch.Generator().manual_seed(0))
         * 5.0}
    payload, ef2 = quantize_tree(g, init_error_feedback(g))
    back = dequantize_tree(payload, g)
    err = float((back["w"] - g["w"]).abs().max())
    scale = float(g["w"].abs().max()) / 127.0
    assert err <= scale * 1.01
    # error feedback holds exactly the quantization residual
    np.testing.assert_allclose(ef2["w"].numpy(),
                               (g["w"] - back["w"]).numpy(), atol=1e-6)


def test_error_feedback_unbiased_over_time():
    g = {"w": torch.full((64,), 0.003)}  # well below one quantization step
    ef = init_error_feedback(g)
    total = torch.zeros(64)
    for _ in range(50):
        restored, ef = ef_update(g, ef)
        total += restored["w"]
    np.testing.assert_allclose(total.numpy(), 0.003 * 50, rtol=0.05)


def test_compressed_training_still_learns():
    tcfg = TrainConfig(steps=25, compress_grads=True, log_every=5,
                       lr=LRSchedule(base=3e-3, warmup=5, total=25))
    _, hist = train(CFG, tcfg, DCFG, _init_fn(), verbose=False, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]


# ---------------------------------------------------------- trainability
PORTED = ["minicpm3-4b", "phi3.5-moe-42b-a6.6b", "deepseek-v2-lite-16b",
          "pixtral-12b"]


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_check_trainable_refuses_other_families(arch, device):
    """SSM, the hybrid and audio are refused the same way on either
    device, before any device is touched (no card is needed to be told);
    the dense, MLA, vision and MoE configs pass."""
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        check_trainable(cfg)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        make_train_step(cfg, TrainConfig(), device=device)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train(cfg, TrainConfig(), DataConfig(cfg.vocab, 8, 2), dict,
              device=device)
    if device == "cpu":
        model = init(cfg, torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(NotImplementedError, match="not yet ported"):
            loss_fn(model, {"tokens": torch.zeros((1, 9), dtype=torch.long)})
    for ok in ("mistral-nemo-12b", "qwen3-14b", "starcoder2-3b", *PORTED):
        check_trainable(get_config(ok))


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_check_trainable_accepts_ported_families(arch, device):
    """MLA (minicpm3-4b), MoE (phi3.5-moe-42b-a6.6b; deepseek-v2-lite-16b,
    MoE and MLA) and vision (pixtral-12b) pass ``check_trainable`` at
    their published and smoke configs, the same on either device: the
    train step is built on the CPU, and without a card the CUDA one fails
    only for the device, never as not ported."""
    for smoke in (False, True):
        check_trainable(get_config(arch, smoke=smoke))
    cfg = get_config(arch, smoke=True)
    if device == "cuda" and not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_train_step(cfg, TrainConfig(), device=device)
        return
    assert make_train_step(cfg, TrainConfig(), device=device).model.cfg is cfg


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b"])
def test_launcher_trains_moe_and_mla_on_the_cpu(arch, capsys):
    """``launch/train.py`` at a MoE + MLA smoke config (deepseek) and an MLA
    one (minicpm3) on the bigram stream: the loss falls over 8 steps."""
    from repro_torch.launch.train import main

    assert main(["--arch", arch, "--device", "cpu", "--steps", "8",
                 "--batch", "4", "--seq", "16", "--lr", "3e-3"]) == 0
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if "loss=" in line]
    assert len(losses) == 8 and losses[-1] < losses[0] - 0.05, losses


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch.train import main

    assert main(["--arch", "qwen3-14b", "--device", "cpu", "--steps", "3",
                 "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "[launch] final loss" in out and "device=cpu" in out
