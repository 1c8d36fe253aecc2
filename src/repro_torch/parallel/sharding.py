"""Logical-axis sharding: named axes of parameters and caches -> mesh specs.

A port of ``repro.parallel.sharding``. Every parameter and cache leaf
carries a tuple of *logical* axis names (one a dim, ``None`` = never
sharded; ``repro_torch.models.param_axes`` / ``cache_axes``). ``AxisRules``
maps each logical name to mesh-axis candidates and resolves them against
the real dim sizes: a candidate that does not divide the dim evenly is
dropped, so qwen3's 40 heads fall back to replicated weights and
sequence-parallel activations, and whisper-tiny resolves to replicated, with
no per-arch case in model code.

- ``fsdp``-style weight sharding (``embed_fsdp``) expands to ``("pod",
  "data")`` when the mesh has a pod axis, so it scales with the whole
  data-parallel degree.
- :class:`P` is the port's ``PartitionSpec``: a tuple of entries (a mesh
  axis name, a tuple of names, or None), trailing Nones dropped, so it
  compares equal to ``tuple()`` of the reference's spec.
- :class:`Mesh` is the port's ``jax.sharding.Mesh``: a numpy array of
  ``torch.device`` and one name an array axis. ``AxisRules`` reads its
  sizes as the reference reads a JAX mesh's, and the fleet
  (``BatchedBOEngine(mesh=...)``) places one scenario group on each
  device of its mesh axis.

``constraint`` (the reference's ``with_sharding_constraint`` by logical
axes) has no counterpart here: see :mod:`repro_torch.parallel`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = ["AxisRules", "Mesh", "NamedSharding", "P", "axis_rules",
           "current_rules", "resolve_spec", "named_sharding", "tree_specs",
           "DEFAULT_RULES"]

# logical axis -> ordered mesh-axis candidates; the first that divides wins.
# ("model",) entries are tensor/expert parallel; "embed_fsdp" is ZeRO weight
# sharding; "batch" is data parallel; "seq"/"cache_seq" are sequence
# parallel (the reference's table).
DEFAULT_RULES: dict[str, tuple[tuple[str, ...], ...]] = {
    "batch": (("pod", "data"), ("data",)),
    "vocab": (("model",),),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "ff": (("model",),),
    "experts": (("model",),),
    "d_inner": (("model",),),
    "ssm_heads": (("model",),),
    "width": (("model",),),
    "conv_dim": (("model",),),
    "embed": (),            # activations' d_model: replicated
    "embed_fsdp": (("pod", "data"), ("data",)),  # a weight's d_model (ZeRO)
    "seq": (("model",),),   # sequence parallelism (activations)
    "cache_seq": (("model",),),  # the decode K/V or latent cache's length
    "head_dim": (),
    "expert_cap": (),
}

# dims with lower numbers claim mesh axes first (4 for any other name)
_PRIORITY = {
    "batch": 0, "vocab": 1, "heads": 1, "kv_heads": 2, "ff": 1, "experts": 1,
    "d_inner": 1, "ssm_heads": 1, "width": 1, "conv_dim": 1, "expert_cap": 6,
    "embed_fsdp": 3, "seq": 5, "cache_seq": 5,
}


class P(tuple):
    """A partition spec: one entry a dim (a mesh axis name, a tuple of
    names, or None for a replicated dim), trailing Nones left out."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _is_axes(t) -> bool:
    """A logical-axes tuple (names or None), not a container of them."""
    return isinstance(t, tuple) and all(a is None or isinstance(a, str)
                                        for a in t)


class Mesh:
    """Devices in an n-dimensional array with one name an axis (the port's
    ``jax.sharding.Mesh``). ``devices`` is array-like (nested lists allowed)
    of ``torch.device`` or device strings; ``mesh.devices`` is a numpy
    object array of ``torch.device``. A device may appear more than once:
    on one card, ``Mesh(["cuda", "cuda"], ("fleet",))`` runs two scenario
    groups on it one after the other, as a test forces two CPU host
    devices for the reference's mesh."""

    def __init__(self, devices, axis_names: Sequence[str] | str):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim == 0:
            arr = arr.reshape(1)
        flat = [torch.device(d) for d in arr.reshape(-1)]
        self.devices = np.empty(arr.shape, dtype=object)
        for i, d in enumerate(flat):
            self.devices.flat[i] = d
        self.axis_names = ((axis_names,) if isinstance(axis_names, str)
                           else tuple(axis_names))
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f"Mesh: {len(self.axis_names)} axis names "
                f"{self.axis_names} for a device array of shape "
                f"{self.devices.shape}")

    @property
    def shape(self) -> dict:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """One device a position along ``axis``: the first of the slice
        through that position (the other axes replicate)."""
        i = self.axis_names.index(axis)
        along = np.moveaxis(self.devices, i, 0)
        return list(along.reshape(along.shape[0], -1)[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


class NamedSharding:
    """A mesh and a :class:`P` over its axis names (the port's
    ``jax.sharding.NamedSharding``: a description, no placement)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = spec

    def __eq__(self, other) -> bool:
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other.spec == self.spec)

    def __hash__(self) -> int:
        return hash((id(self.mesh), self.spec))

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


class AxisRules:
    """A resolved view of (mesh, rules); ``mesh=None`` => replicated."""

    def __init__(self, mesh: Optional[Mesh], rules: Optional[dict] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)
        self.axis_sizes = (dict(zip(mesh.axis_names, mesh.devices.shape))
                           if mesh else {})

    def _candidates(self, name: Optional[str]) -> tuple[tuple[str, ...], ...]:
        if name is None:
            return ()
        return self.rules.get(name, ())

    def resolve_dim(self, name: Optional[str], size: int,
                    taken: set[str]) -> Optional[tuple[str, ...]]:
        """The first candidate mesh-axis tuple that divides ``size`` and
        reuses no mesh axis already taken."""
        for cand in self._candidates(name):
            axes = tuple(a for a in cand if a in self.axis_sizes)
            if not axes or any(a in taken for a in axes):
                continue
            total = int(np.prod([self.axis_sizes[a] for a in axes]))
            if total > 1 and size % total == 0:
                return axes
        return None

    def spec(self, axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> P:
        assert len(axes) == len(shape), (axes, shape)
        taken: set[str] = set()
        out: list[Any] = [None] * len(axes)
        # in priority order, so "heads" claims the model axis before "seq"
        # (sequence parallelism only where the head count cannot shard)
        order = sorted(range(len(axes)),
                       key=lambda i: _PRIORITY.get(axes[i], 4))
        for i in order:
            got = self.resolve_dim(axes[i], int(shape[i]), taken)
            if got is not None:
                taken.update(got)
                out[i] = got if len(got) > 1 else got[0]
        while out and out[-1] is None:  # trailing Nones are implicit
            out.pop()
        return P(*out)

    def sharding(self, axes: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.spec(axes, shape))


_STATE = threading.local()


def current_rules() -> AxisRules:
    return getattr(_STATE, "rules", None) or AxisRules(None)


@contextlib.contextmanager
def axis_rules(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Make ``AxisRules(mesh, rules)`` the thread's current rules."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = AxisRules(mesh, rules)
    try:
        yield _STATE.rules
    finally:
        _STATE.rules = prev


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int]) -> P:
    return current_rules().spec(axes, shape)


def named_sharding(axes: Sequence[Optional[str]], shape: Sequence[int],
                   rules: Optional[AxisRules] = None
                   ) -> Optional[NamedSharding]:
    """The leaf's :class:`NamedSharding` under ``rules`` (the current ones
    by default), None without a mesh."""
    r = rules or current_rules()
    return r.sharding(axes, shape)


def tree_specs(axes_tree: Any, params_tree: Any,
               rules: Optional[AxisRules] = None) -> Any:
    """A tree of logical-axes tuples and a matching tree of tensors (or
    anything with ``.shape``) -> the same tree of :class:`P`. Trees are
    dicts (``param_axes``' ``{name: axes}``), lists or tuples nested to
    any depth; an axes tuple is a leaf."""
    r = rules or current_rules()

    def walk(a, p):
        if _is_axes(a):
            return r.spec(a, p.shape)
        if isinstance(a, dict):
            return {k: walk(a[k], p[k]) for k in a}
        return type(a)(walk(x, y) for x, y in zip(a, p))

    return walk(axes_tree, params_tree)
