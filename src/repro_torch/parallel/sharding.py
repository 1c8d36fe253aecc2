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

- :func:`constraint` is the reference's ``with_sharding_constraint`` by
  logical axes: under a mesh it redistributes a DTensor
  (``torch.distributed.tensor``) to the placements its resolved spec gives
  (:func:`placements`); without a mesh, or on a plain tensor, it returns
  ``x`` itself, so the same model code runs on one device unchanged.
  :meth:`AxisRules.device_mesh` is the ``DeviceMesh`` of the rules' mesh
  over the default process group's ranks (rank i at flat position i), and
  :func:`distribute` places a whole tensor at a leaf's spec.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence

import numpy as np
import torch
from torch.distributed.tensor import DTensor

__all__ = ["AxisRules", "Mesh", "NamedSharding", "P", "axis_rules",
           "current_rules", "resolve_spec", "named_sharding", "tree_specs",
           "DEFAULT_RULES", "constraint", "placements", "distribute",
           "redistribute", "is_sharded", "local_shape_offset",
           "mixed_with_dtensors", "from_local", "contiguous_strides",
           "remat_contexts"]

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
        self._dmesh = None

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` of ``mesh`` over the default process group
        (which must have ``mesh``'s size): rank i at flat position i, the
        mesh's axis names as its dim names, the device type of its devices.
        Built once per rules object (so per thread under ``axis_rules``)."""
        if self._dmesh is None:
            import torch.distributed as dist
            from torch.distributed.device_mesh import DeviceMesh
            n = int(self.mesh.devices.size)
            if not dist.is_initialized() or dist.get_world_size() != n:
                have = dist.get_world_size() if dist.is_initialized() else 0
                raise RuntimeError(
                    f"a mesh of {n} devices needs a process group of {n} "
                    f"ranks; the default group has {have}")
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():  # the mesh holds real rank ids
                self._dmesh = DeviceMesh(
                    self.mesh.devices.flat[0].type,
                    torch.arange(n, device="cpu").reshape(
                        self.mesh.devices.shape),
                    mesh_dim_names=self.mesh.axis_names)
        return self._dmesh

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
#: the rules of a thread that entered none: no mesh, everything replicated
_NO_RULES = AxisRules(None)


def current_rules() -> AxisRules:
    return getattr(_STATE, "rules", None) or _NO_RULES


@contextlib.contextmanager
def _using(rules: Optional[AxisRules]):
    """``rules`` as the thread's current rules (None: none) until exit."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def axis_rules(mesh: Optional[Mesh], rules: Optional[dict] = None):
    """Make ``AxisRules(mesh, rules)`` the thread's current rules."""
    return _using(AxisRules(mesh, rules))


def remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: the forward runs as it
    is, the recompute under the rules current now. Autograd runs a CUDA
    backward, remat's recompute included, on a thread of its own, which
    entered no rules."""
    return contextlib.nullcontext(), _using(getattr(_STATE, "rules", None))


def resolve_spec(axes: Sequence[Optional[str]], shape: Sequence[int]) -> P:
    return current_rules().spec(axes, shape)


def placements(spec: P, mesh: Mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every mesh
    dim that entry d names, ``Replicate()`` on the rest. An entry that names
    several axes, ``("pod", "data")``, shards dim d over all of them, the
    first the major one, as JAX's; DTensor splits a dim over its mesh dims
    left to right, so the entry's axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        idx = [mesh.axis_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {mesh.axis_names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def local_shape_offset(shape: Sequence[int], dmesh, pl) -> tuple:
    """(this rank's local shape, its offset in the whole tensor) of a
    tensor of ``shape`` at placements ``pl`` on ``dmesh`` (computed on real
    tensors, also under a fake tensor mode)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    with unset_fake_temporarily():
        return compute_local_shape_and_global_offset(
            torch.Size(shape), dmesh, pl)


def contiguous_strides(shape: Sequence[int]) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape`` (computed, so that no
    tensor is made: under a fake mode one would count as memory)."""
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose incoming gradient is redistributed to
    given placements before it is taken local."""

    @staticmethod
    def forward(ctx, local, dmesh, pl, grad_pl, shape, stride):
        ctx.dmesh, ctx.grad_pl = dmesh, grad_pl
        return DTensor.from_local(local, dmesh, list(pl), run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != tuple(ctx.grad_pl):
            grad = grad.redistribute(ctx.dmesh, list(ctx.grad_pl))
        return grad.to_local(), None, None, None, None, None


def from_local(local: torch.Tensor, dmesh, pl, grad_pl=None,
               shape=None) -> torch.Tensor:
    """``local`` as a DTensor at ``pl`` (no check) of global ``shape``
    (default: the local shape times the shards, right for even splits
    only), whose gradient comes back at ``grad_pl`` (default: ``pl`` with
    every ``Partial`` replicated: the derivative of a sum is one for each
    of its parts; DTensor's own ``from_local`` would split the incoming
    gradient over the ranks, and only newer torch takes
    ``grad_placements`` there)."""
    from torch.distributed.tensor import Replicate
    stride = None
    if shape is not None:  # a contiguous whole over a contiguous shard
        shape = torch.Size(shape)
        stride = contiguous_strides(shape)
        local = local.contiguous()
    if grad_pl is None:
        grad_pl = [Replicate() if p.is_partial() else p for p in pl]
    if not local.requires_grad:
        return DTensor.from_local(local, dmesh, list(pl), run_check=False,
                                  shape=shape, stride=stride)
    return _FromLocal.apply(local, dmesh, tuple(pl), tuple(grad_pl), shape,
                            stride)


def mixed_with_dtensors():
    """Under a mesh, DTensor's ``implicit_replication``: plain tensors that
    the model code makes itself (positions, masks, a float32 zero) take
    part in DTensor ops as replicated ones; a null context otherwise."""
    if current_rules().mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def is_sharded(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor of the sharded program)."""
    return isinstance(x, DTensor)


def constraint(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``with_sharding_constraint`` by logical axes: ``x`` redistributed to
    the placements of ``current_rules().spec(axes, x.shape)``; ``x`` itself
    when it is a plain tensor or without a mesh."""
    if not isinstance(x, DTensor):
        return x
    r = current_rules()
    if r.mesh is None:
        return x
    return redistribute(x, r.spec(axes, x.shape))


def redistribute(x: torch.Tensor, spec: P) -> torch.Tensor:
    """A DTensor ``x`` at ``spec`` under the current rules' mesh (``x``
    itself where it is there already)."""
    r = current_rules()
    want = placements(spec, r.mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(r.device_mesh, want)


def distribute(t: torch.Tensor, axes: Sequence[Optional[str]],
               rules: Optional[AxisRules] = None,
               spec: Optional[P] = None) -> torch.Tensor:
    """``t`` (the whole tensor, the same on every rank) as a DTensor at the
    spec of ``axes`` under ``rules`` (the current ones by default), or at
    ``spec`` when given: each rank keeps its own slice, nothing is sent.
    ``t`` itself without a mesh."""
    r = rules or current_rules()
    if r.mesh is None:
        return t
    spec = r.spec(axes, t.shape) if spec is None else spec
    pl = placements(spec, r.mesh)
    shape, offset = local_shape_offset(t.shape, r.device_mesh, pl)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local.contiguous(), r.device_mesh, pl,
                              run_check=False, shape=t.shape,
                              stride=contiguous_strides(t.shape))


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
