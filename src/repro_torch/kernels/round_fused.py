"""``round_fused``: one acquisition round over the chunked pool (kernel K4).

:func:`round_select` does, for every pool column of ``pool_c`` [nc, C, d]:

1. recomputes rows ``s0..P-1`` of the cached ``V = L⁻¹·K(x, pool)``
   [nc, m, P, C] **in place**: the RBF entries ``K(x[r], col)`` and a
   forward substitution over the full prefix of each row of ``L``
   (``s0 = 0`` refactors the column, ``s0 >= P`` leaves V as it is);
2. the posterior moments in the fixed order of ``engine._col_moments``
   (start from ``beta[0]·V[0]``, then add rows 1..P-1), de-standardized;
3. the closed-form MES gain averaged over the S frozen frontier samples
   ``ystar`` [S, m] and weighted per objective;
4. ``-inf`` for evaluated columns, and the global first-index argmax (a
   chunk whose scores hold a NaN contributes nothing; all ``-inf`` gives 0).

It returns ``(V, best_idx)`` with ``V`` the updated input tensor and
``best_idx`` a 0-dim int32 tensor on V's device; given ``scores`` [nc, C],
it also writes there the masked score that the argmax reads. On a CPU
tensor it runs :func:`round_select_plain`; on a CUDA tensor it launches
``csrc/round_fused.cu`` once, with the plan of :func:`launch_plan`, or
raises.

Two more uses serve a mutable pool (``core/engine.py``): the engine's pool
scores are one score-only call (``s0 >= P``) with ``scores`` set, and
:func:`refresh_chunks` recomputes whole V chunks (``s0 = 0``) on a gathered
subset of the chunks after a pool edit. A column's arithmetic does not depend
on the chunk grid or on which chunks a call holds, so a refreshed chunk is
bitwise the same chunk of a full ``s0 = 0`` call.

The plain version is written so that every column is computed by the same
element-wise operations whatever the chunk width: sums run in a fixed order
over explicit loops (never a matmul or a reduction whose order depends on the
width), and ``exp``/``erf``/``erfc``/``log`` are taken in float64 and rounded
to float32, because PyTorch's CPU kernels compute the tail of a vectorized
loop with another formula than its body. So a pick does not depend on the
chunk size, and duplicated columns tie exactly.
"""
from __future__ import annotations

import math

import torch

from . import build
from ._common import COUNT_LOCK, check_tensor, on_cpu

__all__ = ["round_select", "round_select_plain", "refresh_chunks",
           "v_update_plain", "col_moments_plain", "mes_plain", "select_plain",
           "launch_plan", "launch_class", "launches", "class_launches"]

#: kernel launches since the count was last set to 0
launches = 0
#: the same launches by class: a round's (:func:`launch_class`), a pool
#: edit's chunk refresh (:func:`refresh_chunks`) and a pool-scores call
#: (``scores`` given)
class_launches = {"refactor": 0, "block_update": 0, "score_only": 0,
                  "refresh": 0, "scores": 0}

_LOG_2PI = math.log(2.0 * math.pi)
_HALF_SQRT2 = 0.5 * math.sqrt(2.0)


def _f64(fn, t: torch.Tensor) -> torch.Tensor:
    """``fn`` evaluated in float64 and rounded to float32 (see the module
    docstring: the same value for every element position)."""
    return fn(t.double()).float()


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """Φ(x) in ``jax.scipy.special.ndtr``'s form (``1 + erf`` near 0,
    ``erfc`` in the tails); float32 arithmetic around float64 erf/erfc."""
    w = x * _HALF_SQRT2
    z = torch.abs(w)
    y = torch.where(z < _HALF_SQRT2, 1.0 + _f64(torch.erf, w),
                    torch.where(w > 0.0, 2.0 - _f64(torch.erfc, z),
                                _f64(torch.erfc, z)))
    return 0.5 * y


def _sq_norms(a: torch.Tensor) -> torch.Tensor:
    """Σ_k a[..., k]² summed in order k = 0, 1, ..."""
    acc = a[..., 0] * a[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * a[..., k]
    return acc


def v_update_plain(ls, var, L, V, x, pool_c, s0: int) -> torch.Tensor:
    """Rows ``s0..P-1`` of every chunk of ``V`` [nc, m, P, C], in place:
    ``V[r] = (K(x[r], col) − Σ_{j<r} L[r, j]·V[j]) / L[r, r]``, the sum taken
    in order j = 0, 1, ... (rows below ``s0`` are the cached ones)."""
    nc, C, d = pool_c.shape
    m, P, _ = L.shape
    if s0 >= P:
        return V
    xs = x[None, s0:, :] / ls[:, None, :]                      # [m, B, d]
    aa = _sq_norms(xs)                                         # [m, B]
    for j in range(nc):
        ps = pool_c[j][None] / ls[:, None, :]                  # [m, C, d]
        bb = _sq_norms(ps)                                     # [m, C]
        cross = xs[:, :, None, 0] * ps[:, None, :, 0]          # [m, B, C]
        for k in range(1, d):
            cross = cross + xs[:, :, None, k] * ps[:, None, :, k]
        d2 = torch.clamp_min((aa[:, :, None] + bb[:, None, :]) - 2.0 * cross,
                             0.0)
        rhs = var[:, None, None] * _f64(torch.exp, -0.5 * d2)  # [m, B, C]
        Vj = V[j]                                              # [m, P, C]
        for r in range(P):
            if r >= s0:
                Vj[:, r] = rhs[:, r - s0] / L[:, r, r, None]
            lo = max(r + 1, s0)
            if lo < P:
                rhs[:, lo - s0:] = (rhs[:, lo - s0:]
                                    - L[:, lo:, r, None] * Vj[:, None, r])
    return V


def col_moments_plain(var, beta, Vc):
    """Posterior mean and std [m, C] of one V chunk [m, P, C], accumulated
    in the fixed order ``beta[0]·V[0]`` then rows 1..P-1 (never a matmul:
    the pick's independence of the chunk size rests on it)."""
    mu = beta[:, 0, None] * Vc[:, 0]
    ss = Vc[:, 0] * Vc[:, 0]
    for p in range(1, Vc.shape[1]):
        mu = mu + beta[:, p, None] * Vc[:, p]
        ss = ss + Vc[:, p] * Vc[:, p]
    return mu, torch.sqrt(torch.clamp_min(var[:, None] - ss, 1e-10))


def mes_plain(mean_d, std_d, ystar, weights) -> torch.Tensor:
    """Weighted MES gain [C] from de-standardized moments [m, C] and frontier
    maxima [S, m]: per objective the S terms are added in order, divided by
    S, weighted, and the objectives added in order."""
    gamma = (ystar[:, :, None] - mean_d[None]) / std_d[None]   # [S, m, C]
    pdf = _f64(torch.exp, (_LOG_2PI + gamma * gamma) / -2.0)
    cdf = torch.clamp(_ndtr(gamma), 1e-9, 1.0)
    term = gamma * pdf / (2.0 * cdf) - _f64(torch.log, cdf)
    af = term[0]
    for s in range(1, term.shape[0]):
        af = af + term[s]
    per = (af / term.shape[0]) * weights[:, None]              # [m, C]
    score = per[0]
    for i in range(1, per.shape[0]):
        score = score + per[i]
    return score


def select_plain(scores: torch.Tensor) -> torch.Tensor:
    """Global first-index argmax of chunked scores [nc, C], as the engine's
    chunk scan takes it: within a chunk the first maximum, across chunks a
    strict ``>`` from ``(-inf, 0)``, so a chunk holding a NaN or only
    ``-inf`` contributes nothing. No host synchronisation."""
    nc, C = scores.shape
    v = scores.amax(dim=1)
    i = scores.argmax(dim=1)
    ok = ~torch.isnan(scores).any(dim=1) & (v > -math.inf)
    vv = torch.where(ok, v, torch.full_like(v, -math.inf))
    j = torch.argmax((ok & (vv == vv.max())).to(torch.uint8)).reshape(1)
    best = j * C + i.gather(0, j)  # gather: no host sync, unlike i[j]
    return torch.where(ok.any(), best, torch.zeros_like(best))[0].to(torch.int32)


def round_select_plain(ls, var, L, V, x, beta, ystar, pool_c, evalm_c,
                       y_mean, y_std, weights, *, s0: int, scores=None):
    """The plain PyTorch version of the round (same arguments, in-place V
    update and ``scores`` output as :func:`round_select`)."""
    v_update_plain(ls, var, L, V, x, pool_c, s0)
    per_chunk = []
    for j in range(pool_c.shape[0]):
        mu, sd = col_moments_plain(var, beta, V[j])
        mean_d = mu * y_std[:, None] + y_mean[:, None]
        std_d = sd * y_std[:, None]
        sc = mes_plain(mean_d, std_d, ystar, weights)
        per_chunk.append(torch.where(evalm_c[j], -math.inf, sc))
    masked = torch.stack(per_chunk)
    if scores is not None:
        scores.copy_(masked)
    return V, select_plain(masked)


def _check(ls, var, L, V, x, beta, ystar, pool_c, evalm_c, y_mean, y_std,
           weights, s0) -> None:
    for name, t, nd in (("ls", ls, 2), ("var", var, 1), ("L", L, 3),
                        ("V", V, 4), ("x", x, 2), ("beta", beta, 2),
                        ("ystar", ystar, 2), ("pool_c", pool_c, 3),
                        ("y_mean", y_mean, 1), ("y_std", y_std, 1),
                        ("weights", weights, 1)):
        check_tensor(name, t, nd)
    check_tensor("evalm_c", evalm_c, 2, torch.bool)
    nc, C, d = pool_c.shape
    m, P = beta.shape
    want = {"ls": (ls, (m, d)), "var": (var, (m,)), "L": (L, (m, P, P)),
            "V": (V, (nc, m, P, C)), "x": (x, (P, d)),
            "ystar": (ystar, (ystar.shape[0], m)),
            "evalm_c": (evalm_c, (nc, C)), "y_mean": (y_mean, (m,)),
            "y_std": (y_std, (m,)), "weights": (weights, (m,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"round_select: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape} (nc={nc}, "
                             f"C={C}, d={d}, m={m}, P={P})")
    if min(nc, C, d, m, P, ystar.shape[0]) < 1:
        raise ValueError("round_select: every dimension must be >= 1")
    if int(s0) < 0:
        raise ValueError(f"round_select: s0 must be >= 0, got {s0}")


def round_select(ls, var, L, V, x, beta, ystar, pool_c, evalm_c, y_mean,
                 y_std, weights, *, s0: int, scores=None):
    """One fused round: ``(V, best_idx)``, V updated in place.

    ``ls`` [m, d] and ``var`` [m] are the exp'd hyperparameters of the
    factorization, ``L`` [m, P, P] its Cholesky factors, ``V`` [nc, m, P, C]
    the cached whitened cross-covariance, ``x`` [P, d] the padded training
    rows, ``beta`` [m, P] the whitened targets, ``ystar`` [S, m] the frozen
    frontier maxima, ``pool_c`` [nc, C, d] the chunked pool, ``evalm_c``
    [nc, C] the evaluated mask, ``y_mean``/``y_std``/``weights`` [m]. ``s0``
    rows of V are reused (0: all recomputed; ``>= P``: score only).
    ``scores`` (optional, [nc, C] float32) receives every column's masked
    score, ``-inf`` on evaluated columns; such a call counts as a
    ``scores`` launch.
    """
    _check(ls, var, L, V, x, beta, ystar, pool_c, evalm_c, y_mean, y_std,
           weights, s0)
    nc, C, _ = pool_c.shape
    if scores is not None:
        check_tensor("scores", scores, 2)
        if tuple(scores.shape) != (nc, C):
            raise ValueError(f"round_select: scores has shape "
                             f"{tuple(scores.shape)}, expected {(nc, C)}")
    args = (ls, var, L, V, x, beta, ystar, pool_c, evalm_c, y_mean, y_std,
            weights)
    if on_cpu(*args, *(() if scores is None else (scores,))):
        return round_select_plain(*args, s0=int(s0), scores=scores)
    P = beta.shape[1]
    cls = "scores" if scores is not None else launch_class(int(s0), P)
    return V, _launch(args, int(s0), scores, nc, cls)


def refresh_chunks(ls, var, L, V, x, beta, ystar, pool_c, evalm_c, y_mean,
                   y_std, weights, *, nc_full: int):
    """Recompute every row of the chunks ``V`` [k, m, P, C] (in place) from
    their pool columns ``pool_c`` [k, C, d]: the dirty chunks of a pool
    edit, gathered from an engine's [nc_full, m, P, C] cache. The arguments
    are :func:`round_select`'s at ``s0 = 0``; the pick is not returned.

    On a CPU tensor it runs :func:`v_update_plain`; on a CUDA tensor one K4
    launch with the plan of the full ``nc_full``-chunk call (a ``refresh``
    launch), or it raises. Either way each refreshed chunk is bitwise that
    chunk of a full ``s0 = 0`` call."""
    _check(ls, var, L, V, x, beta, ystar, pool_c, evalm_c, y_mean, y_std,
           weights, 0)
    args = (ls, var, L, V, x, beta, ystar, pool_c, evalm_c, y_mean, y_std,
            weights)
    if on_cpu(*args):
        return v_update_plain(ls, var, L, V, x, pool_c, 0)
    _launch(args, 0, None, int(nc_full), "refresh")
    return V


def _launch(args, s0: int, scores, plan_nc: int, cls: str) -> torch.Tensor:
    """One K4 launch on CUDA tensors ``args`` (:func:`round_select`'s
    order) with the plan of a ``plan_nc``-chunk call; returns the pick."""
    global launches
    V, beta, ystar, pool_c = args[3], args[5], args[6], args[7]
    nc, C, d = pool_c.shape
    m, P = beta.shape
    plan = launch_plan(plan_nc, C, d, m, P, s0)
    out = torch.empty((), dtype=torch.int32, device=V.device)
    err = build.library().round_fused_launch(
        *(t.data_ptr() for t in args), _scratch(V.device, nc).data_ptr(),
        out.data_ptr(), None if scores is None else scores.data_ptr(), nc, C,
        d, m, P, ystar.shape[0], min(s0, P),
        *(plan[k] for k in PLAN_KEYS), build.stream_ptr(V))
    build.check(err, "round_fused")
    with COUNT_LOCK:
        launches += 1
        class_launches[cls] += 1
    return out


def launch_class(s0: int, P: int) -> str:
    """``refactor`` (s0 = 0), ``block_update`` (0 < s0 < P) or
    ``score_only`` (s0 >= P)."""
    return ("refactor" if s0 <= 0 else "block_update" if s0 < P
            else "score_only")


#: the arguments of a plan, in the launch function's order
PLAN_KEYS = ("ct", "w", "R", "lmode", "xs", "pv", "smem_bytes")
#: dynamic shared memory a plan may take: the 232,448 bytes a Hopper block
#: may opt into, less a margin for the kernel's static shared variable
SMEM_LIMIT = 232_448 - 256
#: lanes per (column, objective) pair and threads a block may have
LANES, MAX_THREADS = 8, 768
MAX_ROWS = 32
#: L staging modes: every row once per block, a two-slot ring of panels,
#: or read from device memory
RESIDENT, RING, DEVICE = 0, 1, 2


def _lstride(P: int) -> int:
    """Row stride of a staged L row (``lstride`` in the kernel): a multiple
    of 4 floats that is 4 mod 8."""
    s = -(-P // 4) * 4
    return s + 4 if s % 8 == 0 else s


def _smem_floats(d, m, P, B, ct, w, R, lmode, xs, pv) -> int:
    """Floats of dynamic shared memory a plan takes (``layout`` in the
    kernel): L, scaled x, its norms, scaled pool, its norms, the V tile
    (a column's rows contiguous), beta's rows beside it and the
    per-objective scores, each region rounded up to 4 floats."""
    Ps, dp, vst = _lstride(P), _lstride(d), _lstride(pv)
    xs = bool(B and xs)
    sizes = (
        0 if not B else m * B * Ps if lmode == RESIDENT
        else 2 * w * R * Ps if lmode == RING else 0,
        0 if not xs else m * B * dp if lmode == RESIDENT else w * R * dp,
        0 if not xs else m * B if lmode == RESIDENT else w * R,
        0 if not xs else w * ct * dp,
        w * ct if B else 0,
        w * ct * vst,
        w * vst,
        w * ct)
    return sum(-(-n // 4) * 4 for n in sizes)


def launch_plan(nc: int, C: int, d: int, m: int, P: int, s0: int) -> dict:
    """The launch plan of one call: ``ct`` columns per tile, ``w``
    objectives per wave (``LANES`` threads per column and objective),
    ``R`` rows per L panel (8 selects the kernel's instance with one row
    a lane), ``lmode`` (``RESIDENT``/``RING``/``DEVICE``),
    ``xs`` (scaled inputs staged), ``pv`` rows of the V tile in shared
    memory, ``threads`` per block, ``tiles`` and ``smem_bytes``.

    Preference: L resident, then in a ring, then in device memory; within
    each, the most objectives per wave, the widest tile and the tallest
    panel that hold all P rows of the V tile. Where nothing holds them, the
    smallest plan keeps what fits of V and reads the rest from device
    memory. Every shape gets a plan."""
    G = LANES
    s0 = min(max(int(s0), 0), P)
    B = P - s0
    ct_min = 32 // G  # a warp holds one objective's columns
    cts = [c for c in (32, 16, 8, 4) if c >= ct_min]
    w0 = min(m, max(1, MAX_THREADS // (32 * G)))
    ws = sorted({w0, max(1, w0 // 2), 1}, reverse=True)
    # panel rows: one 8-row panel for a block update of up to 8 rows (the
    # kernel's 1-row-a-lane instance), else the tallest that fits
    Rs = [G] if B <= G else [MAX_ROWS, MAX_ROWS // 2, MAX_ROWS // 4]
    budget = SMEM_LIMIT // 4

    def plan(ct, w, R, lmode, xs, pv):
        n = _smem_floats(d, m, P, B, ct, w, R, lmode, xs, pv)
        return dict(ct=ct, w=w, R=R, lmode=lmode, xs=int(xs), pv=pv,
                    threads=w * ct * G, tiles=nc * -(-C // ct),
                    smem_bytes=4 * n)

    for lmode, xs in ((RESIDENT, 1), (RING, 1), (DEVICE, 1), (DEVICE, 0)):
        for w in ws:
            for ct in cts:
                for R in (Rs if lmode == RING else Rs[:1]):
                    if _smem_floats(d, m, P, B, ct, w, R, lmode, xs,
                                    P) <= budget:
                        return plan(ct, w, R, lmode, xs, P)
    pv = min(P, budget // (ct_min + 1))
    while pv > 0 and _smem_floats(d, m, P, B, ct_min, 1, G, DEVICE, 0,
                                  pv) > budget:
        pv -= 1 + pv // 64
    return plan(ct_min, 1, G, DEVICE, 0, pv)


_SCRATCH: dict = {}


def _scratch(device, nc: int) -> torch.Tensor:
    """The kernel's zeroed scratch on ``device``: per chunk a packed best
    key (8 bytes) and a NaN flag (4), then a block ticket (4). The kernel's
    last block sets it back to zero, so it is allocated (and zeroed) only
    when a call needs more chunks than any before; calls on one device
    share it, so they must run on one stream."""
    words = -(-(12 * nc + 4) // 8)
    buf = _SCRATCH.get(device)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int64, device=device)
        _SCRATCH[device] = buf
    return buf
