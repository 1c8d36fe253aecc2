"""The dry run's programs: every (arch x shape x mesh) cell as (fn, inputs
sharded on the mesh), with no memory behind them (``repro.launch.specs``).

``abstract_init`` / ``abstract_cache`` build the real modules on the
``meta`` device (``LM(cfg, "meta")``, ``init_cache(..., device="meta")``):
shapes and dtypes only, with their logical axes from ``param_axes`` /
``cache_axes``. :func:`build_cell`, called inside ``axis_rules(mesh, ...)``
and a ``FakeTensorMode``, turns them into DTensors whose local shards are
fake tensors (:func:`fake_dtensor`), so a 42 B-parameter MoE "exists"
there as shapes only. :func:`input_specs` gives the data inputs as
(shape, dtype, spec) triples, the reference's ``ShapeDtypeStruct``\\ s.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs import SHAPES, ArchConfig, ShapeSpec, get_config
from repro_torch.models.model import (LM, cache_axes, cache_leaves,
                                      decode_step, init_cache, param_axes,
                                      prefill)
from repro_torch.parallel.sharding import (AxisRules, P, contiguous_strides,
                                           local_shape_offset, placements)
from repro_torch.train import TrainConfig, TrainState, make_train_step
from repro_torch.train.optimizer import tree_zero1_specs

from .program_stats import dry_attention

__all__ = ["abstract_init", "abstract_cache", "input_specs", "build_cell",
           "CELL_PRESETS", "cell_rules", "InputSpec", "fake_dtensor", "Cell"]


# -------------------------------------------------- per-cell launch presets
# microbatch counts: the reference's, which it chose so that each device's
# live activations fit a 16 GB memory
CELL_PRESETS: dict[tuple[str, str], dict] = {
    ("phi3.5-moe-42b-a6.6b", "train_4k"): dict(microbatch=8),
    ("deepseek-v2-lite-16b", "train_4k"): dict(microbatch=4),
    ("mistral-nemo-12b", "train_4k"): dict(microbatch=4),
    ("qwen3-14b", "train_4k"): dict(microbatch=4),
    ("minicpm3-4b", "train_4k"): dict(microbatch=4),
    ("starcoder2-3b", "train_4k"): dict(microbatch=2),
    ("recurrentgemma-9b", "train_4k"): dict(microbatch=4),
    ("pixtral-12b", "train_4k"): dict(microbatch=4),
    ("mamba2-370m", "train_4k"): dict(microbatch=2),
    ("whisper-tiny", "train_4k"): dict(microbatch=1),
}


def cell_rules(shape: ShapeSpec, arch: Optional[str] = None) -> dict:
    """Shape- and arch-dependent rule overrides (the reference's).

    decode: weights stay resident (no ``embed_fsdp``); a batch of one
    additionally shards the cache's sequence over (data, model), since the
    batch axis cannot shard.

    train/prefill on archs whose head count cannot shard 16-way (qwen3 40
    heads, minicpm3 40, starcoder2 24): sequence parallelism, and "ff"
    disabled where the replicated MLP weights are small (under 8e9 bytes:
    minicpm3 yes, qwen3 no); the head-shardable, attention-free and
    encoder-decoder archs disable "seq" instead.
    """
    rules: dict = {}
    if shape.kind == "decode":
        rules["embed_fsdp"] = ()
        if shape.global_batch == 1:
            rules["cache_seq"] = (("data", "model"), ("model",), ("data",))
    elif arch is not None:
        cfg = get_config(arch)
        if cfg.n_heads == 0 or cfg.n_heads % 16 == 0 or cfg.is_encdec:
            rules["seq"] = ()
        else:
            mlp_bytes = 3 * cfg.d_model * cfg.d_ff * cfg.n_layers * 2
            if mlp_bytes < 8e9:
                rules["ff"] = ()
    return rules


# ------------------------------------------------------------ abstract init
def abstract_init(cfg: ArchConfig) -> tuple[LM, dict]:
    """(the ``LM`` of ``cfg`` on the meta device, ``{name: logical
    axes}``)."""
    model = LM(cfg, "meta")
    return model, param_axes(cfg, model)


def abstract_cache(cfg: ArchConfig, batch: int, length: int
                   ) -> tuple[Any, dict]:
    """(the decode cache on the meta device, ``{leaf: logical axes}``)."""
    return (init_cache(cfg, batch, length, device="meta"), cache_axes(cfg))


def fake_dtensor(shape, dtype, spec: P, rules: AxisRules) -> torch.Tensor:
    """A DTensor of global ``shape`` at ``spec`` whose local shard is a new
    tensor of this rank's shape (a fake one under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    pl = placements(spec, rules.mesh)
    local, _ = local_shape_offset(shape, rules.device_mesh, pl)
    return DTensor.from_local(torch.empty(local, dtype=dtype, device="cpu"),
                              rules.device_mesh, list(pl), run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_strides(shape))


def _shard_model(model: LM, specs: dict, rules: AxisRules) -> LM:
    """Each parameter of ``model`` replaced by a fake DTensor at its
    spec."""
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        setattr(mod, leaf, torch.nn.Parameter(
            fake_dtensor(p.shape, p.dtype, specs[name], rules),
            requires_grad=False))
    return model


class InputSpec(NamedTuple):
    """A data input: global shape, dtype and spec (None: a plain scalar)."""
    shape: tuple
    dtype: torch.dtype
    spec: Optional[P]


def _batch_spec(shape, dtype, rules: AxisRules, axes=("batch",)
                ) -> InputSpec:
    ax = tuple(axes) + (None,) * (len(shape) - len(axes))
    return InputSpec(tuple(shape), dtype, rules.spec(ax, shape))


# ------------------------------------------------------------- input specs
def input_specs(cfg: ArchConfig, shape: ShapeSpec, rules: AxisRules) -> dict:
    """The data inputs of this cell, as :class:`InputSpec`\\ s."""
    B, S = shape.global_batch, shape.seq_len
    batch: dict[str, InputSpec] = {}
    if shape.kind in ("train", "prefill"):
        n = S + 1 if shape.kind == "train" else S
        batch["tokens"] = _batch_spec((B, n), torch.int32, rules)
        if cfg.frontend == "audio":
            batch["frames"] = _batch_spec((B, cfg.enc_len, cfg.d_model),
                                          torch.bfloat16, rules)
        if cfg.frontend == "vision":
            batch["images"] = _batch_spec((B, cfg.n_patches, cfg.d_model),
                                          torch.bfloat16, rules)
    else:  # decode
        batch["token"] = _batch_spec((B,), torch.int32, rules)
        batch["pos"] = InputSpec((), torch.int32, None)
    return batch


def _materialize(specs: dict, rules: AxisRules) -> dict:
    return {k: fake_dtensor(s.shape, s.dtype, s.spec, rules)
            for k, s in specs.items() if s.spec is not None}


# ---------------------------------------------------------------- programs
@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    fn: Callable
    args: tuple
    cfg: ArchConfig
    #: tensors the program allocates before it runs that are not its inputs
    #: (the train step's bf16 compute copy)
    held: Any = None


def build_cell(arch: str, shape_name, rules: AxisRules,
               overrides: Optional[dict] = None) -> Cell:
    """(fn, fake sharded args) for one dry-run cell: ``arch`` a registry id
    (``@smoke`` allowed), ``shape_name`` a key of ``SHAPES`` or a
    ``ShapeSpec``. Call inside ``axis_rules(mesh, ...)`` and a
    ``FakeTensorMode``.

    ``overrides`` (the mesh tuner's design space, see
    ``examples/mesh_tuner_torch.py``): microbatch: int, remat: bool, zero1:
    bool (False: the masters and moments at the plain specs); "rules" is
    the caller's."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    shape_name = shape.name
    preset = dict(CELL_PRESETS.get((arch, shape_name), {}))
    preset.update(overrides or {})
    if "remat" in preset:
        cfg = dataclasses.replace(cfg, remat=bool(preset["remat"]))
    model, axes = abstract_init(cfg)
    specs = {n: rules.spec(axes[n], p.shape)
             for n, p in model.named_parameters()}
    batch = _materialize(input_specs(cfg, shape, rules), rules)

    if shape.kind == "train":
        tcfg = TrainConfig(microbatch=preset.get("microbatch", 1))
        step = make_train_step(cfg, tcfg, "cpu", attention=dry_attention)
        shapes = dict(model.named_parameters())
        zspecs = (tree_zero1_specs(axes, shapes, rules)
                  if preset.get("zero1", True) else specs)

        def leaves():
            return {n: fake_dtensor(p.shape, torch.float32, zspecs[n], rules)
                    for n, p in shapes.items()}

        state = TrainState(torch.zeros((), dtype=torch.int32), leaves(),
                           leaves(), leaves())
        ef = {n: torch.zeros((), dtype=torch.float32) for n in shapes}
        return Cell(arch, shape_name, step, (state, batch, ef), cfg,
                    held=list(step.model.parameters()))

    model = _shard_model(model, specs, rules)
    if shape.kind == "prefill":
        def fn(m, b):
            return prefill(m, b["tokens"], frames=b.get("frames"),
                           images=b.get("images"), attention=dry_attention)
        return Cell(arch, shape_name, fn, (model, batch), cfg)

    cache, c_axes = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    leaves = cache_leaves(cache)
    sharded = {k: fake_dtensor(t.shape, t.dtype,
                               rules.spec(c_axes[k], t.shape), rules)
               for k, t in leaves.items()}
    cache = _rebuild_cache(cache, sharded)

    def fn(m, c, t, pos):
        return decode_step(m, c, t, pos)
    return Cell(arch, shape_name, fn,
                (model, cache, batch["token"], shape.seq_len - 1), cfg)


def _rebuild_cache(cache, leaves: dict):
    """``cache`` with each leaf replaced by ``leaves``' (named as
    ``cache_leaves`` names them)."""
    fields = cache._asdict()
    if all(hasattr(v, "_asdict") for v in fields.values()):
        return type(cache)(**{s: type(part)(**{
            f: leaves[f"{s}.{f}"] for f in part._fields})
            for s, part in fields.items()})
    return type(cache)(**{f: leaves[f] for f in fields})
