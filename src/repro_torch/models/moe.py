"""Top-k Mixture-of-Experts with capacity-based gather/scatter dispatch, a
port of ``repro.models.moe``.

Dispatch is index-based, as in the reference: the tokens routed to each
expert are gathered into [E, C, d] slabs (a zero row stands for an empty
slot), the experts' gated MLPs run as three batched products over the slabs
(``torch.bmm``; the reference leaves its einsums to XLA, outside any
kernel), and the weighted outputs go back to their tokens. The one-hot
[T, E, C] dispatch matrix is never built. Under a mesh the slabs take the
reference's constraints (("experts", "expert_cap", None): expert-parallel
products), the expert weights are gathered but on their experts' dim, as
GSPMD partitions the reference's einsums (``_expert_bmm``), and the index
work runs whole on every rank (``_whole``).

The semantics are the reference's, to the tie and the rounding:

- ``route``: the top k probabilities of a token, ties to the lower expert
  index (``jax.lax.top_k``'s order); the gates renormalized in float32 over
  ``max(sum, 1e-9)``. The router product is taken in ``x``'s dtype, then in
  float32, and its softmax in float32.
- ``capacity``: ``C = min(max(k, round(T·k/E·cf)), T)`` with Python's
  ``round`` (halves to even) on the call's own token count T, so a prefill
  and a decode step have different capacities and a decode step may drop.
- ``arrival_slots``: the slot of an assignment is the number of earlier
  assignments to the same expert in flat (token, rank) order over all
  B·S·k; assignments at or past C are dropped (no routed output; the
  shared experts still apply).
- The experts' SiLU (routed and shared) is ``jax.nn.silu``'s arithmetic,
  ``x · 1/(1 + exp(-x))`` with each step rounded to ``x``'s dtype
  (``silu``). ``F.silu`` rounds once, which moves about a third of bf16
  values by an ulp; the random experts' outputs (fan-in init over E)
  dominate the residual stream, so those flips would show in the logits.
  With it, a bf16 ``moe_apply`` equals the reference's run op by op
  (``jax.disable_jit``) bit for bit.
- The combine: each expert's output [E, C, d] times its gate cast to
  ``x``'s dtype, that product in float32, summed per token over its kept
  experts in ascending expert order (the reference's e-major update order)
  from a float32 zero, cast to ``x``'s dtype, then ``+`` the shared
  experts. The sum is a fixed sequence of gathers and adds, never an
  atomic scatter, so two runs on the card are bitwise equal.

``routing=`` is a test hook with ``route``'s signature, ``(probs, k) ->
expert indices [T, k]``: it may record a run's choices or replay another
run's (the gates are then this run's probabilities at those experts, and
the slots follow from the choices). None routes as above.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.parallel.sharding import (constraint, from_local,
                                          is_sharded, local_shape_offset)
from .layers import GatedMLP, dense_init_, gated_mlp, linear, param, silu

__all__ = ["MoE", "moe_apply", "route", "capacity", "arrival_slots",
           "normalize_gates", "silu"]

#: ``route``'s signature: (probs [T, E] float32, k) -> expert indices [T, k]
Routing = Callable[[torch.Tensor, int], torch.Tensor]


class MoE(torch.nn.Module):
    """The parameters of ``moe_init``: ``router`` [d, E], ``wg``/``wu``
    [E, d, ff], ``wd`` [E, ff, d] in bf16 and, when the config has shared
    experts, ``shared``, a gated MLP of width ``n_shared · moe_d_ff``."""

    #: each parameter's logical axes (``moe_init``'s; ``shared`` has
    #: :class:`~repro_torch.models.layers.GatedMLP`'s)
    AXES = {"router": ("embed_fsdp", None),
            "wg": ("experts", "embed_fsdp", None),
            "wu": ("experts", "embed_fsdp", None),
            "wd": ("experts", None, "embed_fsdp")}

    def __init__(self, cfg, device=None):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.cfg = cfg
        self.router = param((d, E), device)
        self.wg = param((E, d, ff), device)
        self.wu = param((E, d, ff), device)
        self.wd = param((E, ff, d), device)
        self.shared = GatedMLP(d, cfg.n_shared * ff, device) \
            if cfg.n_shared else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """``moe_init``'s distributions (``dense_init``: fan-in is the first
        dim, E for the expert stacks)."""
        for w in (self.router, self.wg, self.wu, self.wd):
            dense_init_(w, generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)

    def forward(self, x, *, routing: Optional[Routing] = None):
        return moe_apply(self, self.cfg, x, routing=routing)


def route(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The experts of the k largest probabilities of each row, largest
    first, ties to the lower index (a stable descending sort)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :k]


def normalize_gates(gate: torch.Tensor) -> torch.Tensor:
    """float32 gates [T, k] over their sum (at least 1e-9)."""
    return gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)


def capacity(T: int, k: int, E: int, capacity_factor: float) -> int:
    """Slots an expert has for a call of T tokens (the reference's
    expression, on Python numbers)."""
    return int(min(max(k, round(T * k / E * capacity_factor)), T))


def arrival_slots(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """For the flat assignments ``e_flat`` [T·k] (in (token, rank) order),
    how many earlier assignments went to the same expert: a stable sort by
    expert, each position less its expert's first (no host sync)."""
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    first = torch.searchsorted(e_sorted, e_sorted)
    slot = torch.empty_like(e_flat)
    slot[order] = torch.arange(e_flat.numel(), device=e_flat.device) - first
    return slot


def _scatter_slots(e_flat, slot, keep, tok_id, E: int, C: int,
                   sentinel: int) -> torch.Tensor:
    """slots[e, s] = the token routed to expert e at capacity slot s, or
    ``sentinel`` for an empty slot. Kept (e, s) pairs are unique; dropped
    assignments all write one spare entry past the table, which is cut off
    (no boolean mask, so no host sync)."""
    slots = torch.full((E * C + 1,), sentinel, dtype=torch.long,
                       device=e_flat.device)
    slots[torch.where(keep, e_flat * C + slot, E * C)] = tok_id
    return slots[:E * C].view(E, C)


def _route_and_slot(probs: torch.Tensor, k: int, E: int, C: int,
                    routing: Optional[Routing]):
    """The index work of a layer on its whole [T, E] probabilities: (the
    experts [T, k], the gates [T, k], the aux loss, the slot table [E, C]
    of token ids (T for an empty slot), each assignment's row of the
    flattened [E·C] slabs (E·C for a dropped one) [T, k])."""
    T, dev = probs.shape[0], probs.device
    eidx = (routing or route)(probs, k)                             # [T, k]
    gate = normalize_gates(torch.gather(probs, 1, eidx))

    # Switch aux loss: E * sum_e(frac_tokens_e * mean_prob_e)
    frac = (eidx[:, :1] == torch.arange(E, device=dev)).float().mean(0)
    aux = E * torch.sum(frac * probs.mean(0))

    e_flat = eidx.reshape(-1)                                       # [T*k]
    slot = arrival_slots(e_flat, E)
    keep = slot < C
    tok_id = torch.arange(T, device=dev).repeat_interleave(k)
    slots = _scatter_slots(e_flat, slot, keep, tok_id, E, C, T)     # [E, C]
    row = torch.where(keep, e_flat * C + slot, E * C)
    return eidx, gate, aux, slots, row


def _gather_slabs(xt: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """[E, C, d]: each slot's token row (a zero row for an empty one)."""
    xpad = torch.cat([xt, xt.new_zeros((1, xt.shape[1]))])
    return xpad[slots]


def _combine(ys: torch.Tensor, gate: torch.Tensor, row: torch.Tensor,
             eidx: torch.Tensor) -> torch.Tensor:
    """Each token's kept expert outputs times their gates, in float32, in
    ascending expert order, cast to ys's dtype: [T, d]."""
    E, C, d = ys.shape
    T, k = eidx.shape
    dt, dev = ys.dtype, ys.device
    # each kept assignment's row of ys times its gate, in float32; a zero
    # row at E*C stands for a dropped one (whose gates land in the spare
    # entry E*C of gslot and are cut off)
    gslot = torch.zeros(E * C + 1, dtype=torch.float32, device=dev)
    gslot[row] = gate.reshape(-1)
    contrib = (ys.reshape(E * C, d) * gslot[:E * C, None].to(dt)).float()
    contrib = torch.cat([contrib, contrib.new_zeros((1, d))])
    row = row.view(T, k)
    # a token's kept contributions in ascending expert order
    row = torch.gather(row, 1, torch.argsort(eidx, dim=1))
    y = torch.zeros((T, d), dtype=torch.float32, device=dev)
    for j in range(k):
        y = y + contrib[row[:, j]]
    return y.to(dt)


class _ExpertProduct(torch.autograd.Function):
    """``x @ w`` on a rank's local slabs x [e, c, n] and its experts' whole
    weights ``w`` [e, n, m] (no gradient of its own), whose backward gives
    x's gradient whole and the weight's at this rank's slice ``[lo, lo +
    n_part)`` of its ff dim ``dim`` only (2: the columns of ``wg``/``wu``;
    1: the rows of ``wd``), the gradient of ``w_part``."""

    @staticmethod
    def forward(ctx, x, w_part, w, dim, lo):
        ctx.save_for_backward(x, w)
        ctx.slice = (dim, slice(lo, lo + w_part.shape[dim]))
        return torch.bmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dim, sl = ctx.slice
        dx = torch.bmm(dy, w.transpose(1, 2))
        dw = torch.bmm(x.transpose(1, 2), dy[..., sl]) if dim == 2 else \
            torch.bmm(x[..., sl].transpose(1, 2), dy)
        return dx, dw, None, None, None


def _expert_bmm(x: torch.Tensor, w: torch.Tensor, ff_dim: int
                ) -> torch.Tensor:
    """``torch.bmm(x, w)`` for slabs x [E, C, n] and expert weights w [E, n,
    m] whose ff dim is ``ff_dim`` (2 for ``wg``/``wu``, 1 for ``wd``); on
    DTensors as GSPMD partitions the reference's einsums and their
    gradients:

    - the experts split alike in x and w (expert parallelism);
    - on every other mesh dim w gathered (its ``embed_fsdp`` split: the
      FSDP all-gather) and x kept at its placements (its capacity split, or
      whole), so each rank multiplies its experts' slabs by their whole
      weights (one local ``bmm``) and x's gradient is whole there;
    - the weight's gradient split on its ff dim over the mesh dims where x
      is whole (each rank computes its slice only: ``_ExpertProduct``),
      as a partial sum over those that split the capacity.

    DTensor's own rule would split the contraction over the data axis
    (partial sums), and in the backward the weights' gradients over the
    capacity dim."""
    if not (is_sharded(x) or is_sharded(w)):
        return torch.bmm(x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (x if is_sharded(x) else w).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not is_sharded(x):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not is_sharded(w):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    xp, wp, part, part_grad = [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if a == Shard(0) or b == Shard(0):         # experts
            xp.append(Shard(0))
            wp.append(Shard(0))
            part.append(Shard(0))
            part_grad.append(Shard(0))
        elif a == Shard(1):                        # the capacity
            xp.append(Shard(1))
            wp.append(Replicate())
            part.append(Replicate())
            part_grad.append(Partial())
        else:                                      # x whole: ff split
            xp.append(Replicate())
            wp.append(Replicate())
            part.append(Shard(ff_dim))
            part_grad.append(Shard(ff_dim))
    x_loc = x.redistribute(mesh, xp).to_local(grad_placements=xp)
    w_loc = w.detach().redistribute(mesh, wp).to_local()
    if torch.is_grad_enabled() and w.requires_grad:
        lo = local_shape_offset(w.shape, mesh, part)[1][ff_dim]
        y = _ExpertProduct.apply(
            x_loc, w.redistribute(mesh, part).to_local(
                grad_placements=part_grad), w_loc, ff_dim, lo)
    else:  # no weight gradient (a prefill): the product alone
        y = torch.bmm(x_loc, w_loc)
    return from_local(y, mesh, xp, shape=tuple(x.shape[:2]) + (
        w.shape[-1],))


def _whole(fn, *tensors):
    """``fn`` on plain tensors; on DTensors it runs on each rank's whole
    (replicated) copies and returns replicated DTensors. The routing's
    sort, ``searchsorted``, scatters and gathers count over every token of
    the layer (an arrival slot depends on all earlier tokens), which no
    sharded rule of DTensor's computes (it has none for ``searchsorted``),
    so they run whole, as GSPMD gathers them."""
    if not any(is_sharded(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import Replicate
    mesh = next(t for t in tensors if is_sharded(t)).device_mesh
    rep = [Replicate()] * mesh.ndim
    out = fn(*[t.redistribute(mesh, rep).to_local() if is_sharded(t) else t
               for t in tensors])
    if isinstance(out, tuple):
        return tuple(from_local(o, mesh, rep) for o in out)
    return from_local(out, mesh, rep)


def moe_apply(p, cfg, x: torch.Tensor, *,
              routing: Optional[Routing] = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], the Switch load-balancing aux loss, a
    float32 scalar). ``p`` holds ``moe_init``'s parameters (a :class:`MoE`);
    they are cast to ``x``'s dtype at use. On DTensors the routing, the
    slab gather and the combine run whole on every rank (:func:`_whole`)
    and the experts' products on slabs sharded over ("experts",
    "expert_cap", None), the reference's constraints, with the expert
    weights gathered but on their experts (:func:`_expert_bmm`)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, d)

    probs = torch.softmax(linear(xt, p.router.to(dt)).float(), dim=-1)  # [T, E]
    C = capacity(T, k, E, getattr(cfg, "capacity_factor", 1.25))

    eidx, gate, aux, slots, row = _whole(
        lambda pr: _route_and_slot(pr, k, E, C, routing), probs)

    xs = constraint(_whole(_gather_slabs, xt, slots),
                    "experts", "expert_cap", None)                  # [E, C, d]
    h = silu(_expert_bmm(xs, p.wg.to(dt), 2)) * \
        _expert_bmm(xs, p.wu.to(dt), 2)
    ys = _expert_bmm(h, p.wd.to(dt), 1)                             # [E, C, d]
    ys = constraint(ys, "experts", "expert_cap", None)
    y = _whole(_combine, ys, gate, row, eidx)
    if p.shared is not None:
        y = y + gated_mlp(p.shared, xt)
    return y.view(B, S, d), aux
