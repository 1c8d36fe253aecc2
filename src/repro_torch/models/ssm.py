"""The Mamba-2 SSD (state-space duality) block, ``repro.models.ssm`` on
PyTorch (mamba2-370m).

The reference computes SSD outside any Pallas kernel, so this module is
plain torch on both devices, in the reference's own form:

- ``_conv1d``: the depthwise causal conv of width W, its W products summed
  in the compute dtype in the order i = 0..W-1, then SiLU step by step
  (:func:`~.layers.silu`); the new window is the last W-1 rows of the
  padded input (zero rows while the sequence is shorter than W-1).
- ``_ssd_chunked``: the prefill (and the loss's trunk), in float32. Within
  a chunk, the decay-masked quadratic form, its mask applied before the
  exponential (the reference applies it after, and its gradient at a chunk
  of 256 is NaN: ROADMAP queue 3); across chunks, the carried state [B, H,
  hd, N] in a Python loop over the chunks (the reference's ``lax.scan``);
  it returns the final state.
- ``mamba2_apply``: the prefill right-pads the sequence to a whole
  ``ssm_chunk`` with dt = 0 (identity steps), decode is the one-token
  recurrence ``h = exp(dt·A)·h + dt·x·Bᵀ``, ``y = C·h``; then the ``D``
  skip and the gated ``rms_norm(y · silu(z))``.

A decode step writes its layer's cache in place (the reference returns a
new cache with the same values).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import constraint, from_local, is_sharded
from .layers import (dense_init_, linear, param, rms_norm, rms_norm_init_,
                     silu, softplus)

__all__ = ["Mamba2", "mamba2_apply", "SSMCache", "init_ssm_cache"]


class SSMCache(NamedTuple):
    conv: torch.Tensor   # [B, W-1, conv_dim] rolling conv window (a model's: [L, B, ...])
    state: torch.Tensor  # [B, H, hd, N] recurrent SSD state, float32


#: one layer's cache axes (``init_ssm_cache``'s)
SSM_CACHE_AXES = SSMCache(("batch", None, "conv_dim"),
                          ("batch", "ssm_heads", None, None))


def _dims(cfg) -> tuple[int, int, int]:
    d_in = cfg.ssm_heads * cfg.ssm_head_dim
    n = cfg.ssm_state * cfg.ssm_groups
    return d_in, n, d_in + 2 * n


class Mamba2(torch.nn.Module):
    """The parameters of ``mamba2_init``: ``wz``/``wx`` [d, d_in], ``wbc``
    [d, 2N], ``wdt`` [d, H], ``conv_w`` [W, conv_dim] and ``wo`` [d_in, d]
    in bf16; ``A_log``, ``D``, ``dt_bias`` [H] and ``norm`` [d_in] in
    float32."""

    #: each parameter's logical axes (``mamba2_init``'s)
    AXES = {"wz": ("embed_fsdp", "d_inner"), "wx": ("embed_fsdp", "d_inner"),
            "wbc": ("embed_fsdp", None), "wdt": ("embed_fsdp", "ssm_heads"),
            "conv_w": (None, "conv_dim"), "A_log": ("ssm_heads",),
            "D": ("ssm_heads",), "dt_bias": ("ssm_heads",), "norm": (None,),
            "wo": ("d_inner", "embed_fsdp")}

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.ssm_heads
        d_in, n, conv_dim = _dims(cfg)
        self.cfg = cfg
        self.wz = param((d, d_in), device)
        self.wx = param((d, d_in), device)
        self.wbc = param((d, 2 * n), device)
        self.wdt = param((d, H), device)
        self.conv_w = param((cfg.conv_width, conv_dim), device)
        self.A_log = param((H,), device, torch.float32)
        self.D = param((H,), device, torch.float32)
        self.dt_bias = param((H,), device, torch.float32)
        self.norm = param((d_in,), device, torch.float32)
        self.wo = param((d_in, d), device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """``mamba2_init``'s distributions: fan-in truncated normals, the
        conv at scale 0.5, ``A_log`` and ``dt_bias`` 0, ``D`` and ``norm``
        1."""
        for w in (self.wz, self.wx, self.wbc, self.wdt):
            dense_init_(w, generator)
        dense_init_(self.conv_w, generator, scale=0.5)
        self.A_log.zero_()
        self.D.fill_(1.0)
        self.dt_bias.zero_()
        rms_norm_init_(self.norm)
        dense_init_(self.wo, generator)

    def forward(self, x, cache=None, cache_pos=None):
        return mamba2_apply(self, self.cfg, x, cache, cache_pos)


def _conv1d(xbc: torch.Tensor, w: torch.Tensor,
            prev: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv of width W: xbc [B, S, C], prev [B, W-1, C] or
    None (zeros). Returns (silu(out) [B, S, C], the new window [B, W-1, C])."""
    W = w.shape[0]
    if prev is None:
        prev = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    xp = torch.cat([prev, xbc], dim=1)                 # [B, S+W-1, C]
    S = xbc.shape[1]
    out = sum(xp[:, i: i + S] * w[i].to(xbc.dtype) for i in range(W))
    return silu(out), xp[:, -(W - 1):]


def _ssd_chunked(xh, B_, C_, dt, A, chunk: int):
    """SSD over chunks, in float32. xh [B, S, H, hd]; B_/C_ [B, S, N]; dt
    [B, S, H] (softplus'd); A [H] (negative). Returns (y [B, S, H, hd], the
    final state [B, H, hd, N])."""
    Bb, S, H, hd = xh.shape
    N = B_.shape[-1]
    if S % chunk:
        raise ValueError(f"_ssd_chunked: S={S} is not a multiple of {chunk}")
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=xh.device).tril()
    state = torch.zeros((Bb, H, hd, N), dtype=torch.float32, device=xh.device)
    ys = []
    for c0 in range(0, S, chunk):
        x, b = xh[:, c0:c0 + chunk], B_[:, c0:c0 + chunk].float()
        c, dtt = C_[:, c0:c0 + chunk].float(), dt[:, c0:c0 + chunk]
        # per-step log decay dt_t·A (A negative), inclusive cumulative sum
        cum = torch.cumsum(dtt * A[None, None, :], dim=1)   # [B, c, H]
        # within the chunk: L[i, j] = exp(cum_i - cum_j) for i >= j, else 0.
        # The mask goes before the exponential: above the diagonal cum_i -
        # cum_j > 0, and over a chunk of 256 steps it passes 88.7, where
        # exp overflows to inf. The reference's where(tri, exp(diff), 0)
        # drops those entries in the forward (so this form's values are
        # the same bit for bit: exp(-inf) = 0), but its backward multiplies
        # their zero gradient by inf, NaN (ROADMAP queue 3). wdec and
        # exp(cum) below take arguments <= 0 (cum falls): they never
        # overflow.
        diff = cum[:, :, None, :] - cum[:, None, :, :]      # [B, i, j, H]
        L = torch.exp(diff.masked_fill(~tri[None, :, :, None], -math.inf))
        g = torch.einsum("bin,bjn->bij", c, b)[..., None] * L
        xin = x.float() * dtt[..., None].float()
        y_intra = torch.einsum("bijh,bjhp->bihp", g, xin)
        # the carried state's contribution
        y_state = torch.einsum("bin,bhpn->bihp", c, state) \
            * torch.exp(cum)[..., None]
        # state' = exp(sum la)·state + sum_j exp(cum_last - cum_j) dt_j x_j b_jᵀ
        wdec = torch.exp(cum[:, -1:, :] - cum)              # [B, c, H]
        upd = torch.einsum("bjhp,bjn->bhpn", xin * wdec[..., None], b)
        state = torch.exp(cum[:, -1])[:, :, None, None] * state + upd
        ys.append(y_intra + y_state)
    return torch.cat(ys, dim=1), state


def _heads_view(x: torch.Tensor, H: int, hd: int) -> torch.Tensor:
    """x [B, S, H·hd] viewed [B, S, H, hd]. A DTensor split on its last dim
    into a number of shards that does not divide H is gathered there first
    (a shard boundary inside a head cannot be viewed)."""
    if is_sharded(x):
        from torch.distributed.tensor import Replicate, Shard
        n = 1
        for size, p in zip(x.device_mesh.shape, x.placements):
            n *= size if p == Shard(2) else 1
        if H % n:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p == Shard(2) else p for p in x.placements])
    B, S, _ = x.shape
    return x.reshape(B, S, H, hd)


def _ssd_sharded(xh, B_, C_, dt, A, chunk: int):
    """:func:`_ssd_chunked` on DTensors, on each rank's shards: every
    (sequence, head) pair is independent, so x, dt and A keep their batch
    and head splits, B and C their batch split (whole over the heads';
    their gradient there is a partial sum, as A's over the batch's), and
    the loop over chunks runs on local tensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = xh.device_mesh
    xp = [p if p in (Shard(0), Shard(2)) else Replicate()
          for p in xh.placements]
    bp = [Shard(0) if p == Shard(0) else Replicate() for p in xp]
    heads = [Shard(0) if p == Shard(2) else Replicate() for p in xp]
    dtp = [p if p in (Shard(0), Shard(2)) else Replicate() for p in xp]
    bgrad = [Partial() if p == Shard(2) else q for p, q in zip(xp, bp)]
    # A [H] serves every sequence of the rank: a partial sum over the
    # batch's splits
    agrad = [Partial() if p == Shard(0) else q for p, q in zip(xp, heads)]
    if not is_sharded(A):
        A = DTensor.from_local(A, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    y, state = _ssd_chunked(
        xh.redistribute(mesh, xp).to_local(),
        B_.redistribute(mesh, bp).to_local(grad_placements=bgrad),
        C_.redistribute(mesh, bp).to_local(grad_placements=bgrad),
        dt.redistribute(mesh, dtp).to_local(),
        A.redistribute(mesh, heads).to_local(grad_placements=agrad), chunk)
    Bb, S, H, hd = xh.shape
    st_pl = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
             else Replicate() for p in xp]
    return (from_local(y, mesh, xp, shape=xh.shape),
            from_local(state, mesh, st_pl, shape=(Bb, H, hd, B_.shape[-1])))


def mamba2_apply(p, cfg, x: torch.Tensor, cache: Optional[SSMCache] = None,
                 cache_pos: Optional[int] = None
                 ) -> tuple[torch.Tensor, Optional[SSMCache]]:
    """``repro.models.ssm.mamba2_apply``: x [B, S, d]. The chunked prefill
    when ``cache`` is None (returning the layer's SSMCache when
    ``cache_pos`` is given), else one recurrent decode step (S == 1) that
    writes ``cache`` in place."""
    B, S, d = x.shape
    H, hd = cfg.ssm_heads, cfg.ssm_head_dim
    d_in, n, _ = _dims(cfg)
    dt_ = x.dtype
    z = linear(x, p.wz.to(dt_))
    xr = linear(x, p.wx.to(dt_))
    bc = linear(x, p.wbc.to(dt_))
    dt_raw = linear(x, p.wdt.to(dt_))
    dt = softplus(dt_raw.float() + p.dt_bias[None, None, :])   # [B, S, H]
    A = -torch.exp(p.A_log.float())                             # [H]

    xbc, conv_new = _conv1d(torch.cat([xr, bc], dim=-1), p.conv_w,
                            None if cache is None else cache.conv)
    B_ = xbc[..., d_in: d_in + n]
    C_ = xbc[..., d_in + n:]
    xh = _heads_view(constraint(xbc[..., :d_in], "batch", None, "d_inner"),
                     H, hd)

    if cache is None:
        pad = (-S) % cfg.ssm_chunk
        xs, Bs, Cs, dts = xh, B_, C_, dt
        if pad:  # right-pad to a whole chunk (dt = 0: identity steps)
            xs = F.pad(xh, (0, 0, 0, 0, 0, pad))
            Bs, Cs, dts = (F.pad(t, (0, 0, 0, pad)) for t in (B_, C_, dt))
        ssd = _ssd_sharded if is_sharded(xs) else _ssd_chunked
        y, state = ssd(xs, Bs, Cs, dts, A, min(cfg.ssm_chunk, xs.shape[1]))
        y = y[:, :S]
        new_cache = SSMCache(conv_new, state) if cache_pos is not None \
            else None
    else:
        if S != 1:
            raise ValueError(f"mamba2_apply: decode takes one token, got "
                             f"S={S}")
        la = torch.exp(dt[:, 0, :] * A[None, :])                # [B, H]
        xin = xh[:, 0].float() * dt[:, 0, :, None]              # [B, H, hd]
        upd = torch.einsum("bhp,bn->bhpn", xin, B_[:, 0].float())
        state = la[:, :, None, None] * cache.state + upd
        y = torch.einsum("bn,bhpn->bhp", C_[:, 0].float(), state)[:, None]
        cache.conv.copy_(conv_new)
        cache.state.copy_(state)
        new_cache = cache

    y = y + xh.float() * p.D[None, None, :, None]
    y = y.reshape(B, S, d_in).to(dt_)
    y = rms_norm(y * silu(z), p.norm, cfg.norm_eps)             # gated norm
    return linear(y, p.wo.to(dt_)), new_cache


def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16, device=None,
                   n_layers: Optional[int] = None) -> SSMCache:
    """A zeroed cache: ``conv`` [B, W-1, conv_dim] in ``dtype``, ``state``
    [B, H, hd, N] in float32; [n_layers, ...] each when given (a model's,
    its layers stacked)."""
    lead = (batch,) if n_layers is None else (n_layers, batch)
    _, _, conv_dim = _dims(cfg)
    return SSMCache(
        torch.zeros(lead + (cfg.conv_width - 1, conv_dim), dtype=dtype,
                    device=device),
        torch.zeros(lead + (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                    dtype=torch.float32, device=device))
