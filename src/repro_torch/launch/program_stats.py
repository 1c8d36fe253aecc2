"""Per-device statistics of one run of a sharded program: the counterpart
of ``repro.launch.hlo_stats``.

The reference compiles a cell for a 512-device CPU mesh and walks XLA's
optimized HLO, multiplying each ``while`` body by its trip count. The
port has no compiled program to walk: it runs the cell once, eagerly, on
DTensors over a fake process group (``launch.mesh``) under
``FakeTensorMode`` (no memory, no arithmetic), and counts what this rank
runs. :class:`Counter` is a ``TorchDispatchMode`` that steps aside for
DTensor ops (it returns ``NotImplemented``), so it sees the *local* ops
that DTensor runs on each shard, and the functional collectives it runs:

- ``dot_flops``: each matmul-class op (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ...) counted on its local shapes by
  ``torch.utils.flop_counter``'s formulas (2·M·N·K a product). Not
  ``FlopCounterMode`` over the DTensors: that counts the global op, the
  mesh's size times one device's work. Attention in a dry run goes through
  :func:`dry_attention`, one op whose flops are the reference's ``_sdpa``
  dots (q·kᵀ and p·v over all Sq × Sk, the masked half included) and, in
  the backward, twice that, as ``jax.grad`` of those einsums has;
- ``dot_bytes``: the two operands and the result of each of those ops;
- ``coll_bytes`` / ``coll_counts`` by kind: the result bytes of each
  ``_c10d_functional`` collective (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``);
- ``argument_bytes``, ``output_bytes``, ``peak_bytes``, ``temp_bytes``:
  this rank's local storages: the program's inputs, its outputs, the most
  live at once during the run, and that peak less the inputs.

No value is given for what has no faithful counterpart: XLA's raw
``cost_analysis`` numbers (``xla_flops_raw``, ``xla_bytes_raw``), the
size of generated code, the ``while`` trip counts (an eager run has no
loops to correct), ``collective-permute`` (DTensor runs none) and the
collectives GSPMD would choose: DTensor picks its own redistributions
(for example a partial sum over a sharded contraction where GSPMD might
gather the weight), so ``coll_bytes`` are DTensor's program's, not XLA's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["ProgramStats", "Counter", "dry_attention", "fake_safe_dtensor",
           "COLLECTIVES"]

#: each functional collective op (by name) -> the reference's kind
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",   # DTensor's Shard(i) -> Shard(j)
}


@dataclasses.dataclass
class ProgramStats:
    """One rank's counts (``repro.launch.hlo_stats.HLOStats``'s fields, and
    the memory the reference reads from ``memory_analysis``)."""
    dot_flops: float = 0.0
    dot_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)
    coll_counts: dict = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0

    @property
    def coll_total(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def temp_bytes(self) -> int:
        return max(self.peak_bytes - self.argument_bytes, 0)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t):
    """A DTensor's local shard, else ``t``."""
    return getattr(t, "_local_tensor", t)


_ACTIVE: list["Counter"] = []


class Counter(TorchDispatchMode):
    """Counts this rank's local dots, collectives and live storage bytes
    while it is entered (see the module docstring). ``track(tree)`` marks
    the tensors of ``tree`` (the program's inputs) as live from the start;
    ``finish(outputs)`` records the outputs' bytes."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.stats = ProgramStats()
        self._live: dict[int, int] = {}
        self._cur = 0

    # ---------------------------------------------------------- memory
    def _add_storage(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._cur += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._cur)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._cur -= self._live.pop(key, 0)

    def track(self, tree: Any, argument: bool = True) -> int:
        """Mark every tensor of ``tree`` live (the program's inputs, or with
        ``argument=False`` what it allocated before it ran); returns their
        local bytes (counted once a storage)."""
        before = self._cur
        for t in tree_flatten(tree)[0]:
            ts = (list(t.parameters()) if isinstance(t, torch.nn.Module)
                  else [t])
            for x in ts:
                if isinstance(x, torch.Tensor):
                    self._add_storage(_local(x))
        added = self._cur - before
        if argument:
            self.stats.argument_bytes += added
        return added

    def finish(self, outputs: Any) -> None:
        seen = set()
        for t in tree_flatten(outputs)[0]:
            if isinstance(t, torch.Tensor):
                st = _local(t).untyped_storage()
                if id(st) not in seen:
                    seen.add(id(st))
                    self.stats.output_bytes += st.nbytes()

    # ------------------------------------------------------------ ops
    def add_dot(self, flops: float, nbytes: float) -> None:
        self.stats.dot_flops += flops
        self.stats.dot_bytes += nbytes

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs; its local ops come back
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in self.registry:
            flops = self.registry[packet](*args, **kwargs, out_val=out)
            ops = [a for a in args[:3] if isinstance(a, torch.Tensor)]
            nb = sum(_nbytes(a) for a in ops[-2:])
            self.add_dot(float(flops), nb + sum(
                _nbytes(o) for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)))
        elif func.namespace in ("_c10d_functional",
                                "_c10d_functional_autograd", "_dtensor"):
            kind = COLLECTIVES.get(packet.__name__)
            if kind is not None:
                nb = sum(_nbytes(o) for o in tree_flatten(out)[0]
                         if isinstance(o, torch.Tensor))
                s = self.stats
                s.coll_bytes[kind] = s.coll_bytes.get(kind, 0.0) + nb
                s.coll_counts[kind] = s.coll_counts.get(kind, 0) + 1
        for o in tree_flatten(out)[0]:
            if isinstance(o, torch.Tensor):
                self._add_storage(o)
        return out


# ------------------------------------------------------------- attention
def _attn_flops(q, k, v) -> float:
    """The reference's ``_sdpa`` dots on these shapes: q·kᵀ and p·v over
    every (query, key) pair."""
    B, Sq, H, Dqk = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    return 2.0 * B * H * Sq * Sk * (Dqk + Dv)


def _attn_bytes(q, k, v) -> float:
    return float(sum(_nbytes(t) for t in (q, k, v))
                 + q.shape[0] * q.shape[1] * q.shape[2] * v.shape[-1]
                 * q.element_size())


class _DryAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if _ACTIVE:
            _ACTIVE[-1].add_dot(_attn_flops(q, k, v), _attn_bytes(q, k, v))
        return q.new_empty(q.shape[:3] + (v.shape[-1],))

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if _ACTIVE:
            _ACTIVE[-1].add_dot(2 * _attn_flops(q, k, v),
                                2 * _attn_bytes(q, k, v))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def dry_attention(q, k, v, scale: float, window: Optional[int] = None,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """K5's signature for a dry run: the output's shape [B, Sq, H, Dv] and
    the reference's ``_sdpa`` dots counted (a fake tensor holds no values,
    so there is nothing to compute), with no [B, H, Sq, Sk] temporaries, as
    K5 keeps none. A query shard (``q_offset``, Sq < Sk) counts its own
    rows against every key, as ``_sdpa`` does."""
    return _DryAttention.apply(q, k, v)


#: any q·k width is taken, so MLA's prefill hands it q and k at the
#: reference's width (K5 takes multiples of 16: the smoke dims' 24 are
#: zero-padded to 32 for it), and the dots are counted at that width
dry_attention.takes_any_head_dim = True


# ---------------------------------------------------- fake-mode DTensor
@contextlib.contextmanager
def fake_safe_dtensor():
    """DTensor's sharding propagation and ``_StridedShard``'s shard sizes
    compute on small real tensors (rank indices) and on global-shape fake
    tensors of their own; under ``FakeTensorMode`` the first become fake
    and ``.item()`` raises (torch 2.13), and a :class:`Counter` would count
    the second. Run both with every mode unset. Also
    DTensor's Shard(i) -> Shard(j) transition runs its all-to-all op as on
    a CUDA mesh (on a CPU mesh it falls back to an all-gather, as gloo has
    no all-to-all). For the dry run only."""
    from torch.distributed.tensor import _dispatch, placement_types
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes
    patched = [(ShardingPropagator, "propagate_op_sharding_non_cached")]
    _StridedShard = getattr(placement_types, "_StridedShard", None)
    if _StridedShard is not None:
        patched.append((_StridedShard, "local_shard_size_and_offset"))
    patched = [(c, n) for c, n in patched if n in c.__dict__]
    # module attributes replaced outright: the CUDA program's all-to-all
    # (not the all-gather DTensor falls back to on a CPU mesh), and
    # DTensor's "are we tracing" test, which a fake mode turns on and which
    # then skips its sharding cache (every op searched anew: ~10x slower)
    swaps = {(placement_types, "shard_dim_alltoall"): _shard_dim_alltoall,
             (_dispatch, "_are_we_tracing"): lambda: False}
    saved = []
    for (mod, name), fn in swaps.items():
        if hasattr(mod, name):  # names of this torch's DTensor (2.11-2.13)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
    for cls, name in patched:
        orig = cls.__dict__[name]
        fn = orig.__func__ if isinstance(orig, staticmethod) else orig

        def wrapped(*a, _fn=fn, **k):
            with _disable_current_modes():
                return _fn(*a, **k)

        setattr(cls, name, staticmethod(wrapped)
                if isinstance(orig, staticmethod) else wrapped)
        saved.append((cls, name, orig))
    try:
        yield
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


def _shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's ``shard_dim_alltoall`` as it runs on a CUDA mesh: the
    ``_dtensor`` all-to-all op (whose fake version gives its shape)."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)
