"""``pairdist``: pairwise squared distances, optionally fused RBF (kernel K2).

:func:`pairdist` returns ``max(‖x_i‖² + ‖y_j‖² − 2 x_i·y_j, 0)`` [N, M] for
``x`` [N, D], ``y`` [M, D], or ``exp(−d² / (2σ² + 1e-12))`` when
``bandwidth`` σ is given. On a CPU tensor it runs :func:`pairdist_plain`; on
a CUDA tensor it launches ``csrc/pairdist.cu`` or raises.

``differentiable=True`` takes the plain form on any device: the kernel has no
backward, exactly as the JAX package pins its XLA form for the GP's NLL
gradient. That is the reference's own rule, not a fallback.
"""
from __future__ import annotations

import torch

from . import build
from ._common import COUNT_LOCK, check_tensor, on_cpu

__all__ = ["pairdist", "pairdist_chunked", "pairdist_plain", "launch_plan",
           "launches", "shape_launches"]

#: kernel launches since the count was last set to 0
launches = 0
#: the same launches by shape: (n, m, d, "d2" or "rbf") -> count
shape_launches: dict = {}

#: threads per block edge and columns per tile of ``csrc/pairdist.cu``
SIDE, COLS = 16, 64
#: blocks a tile of 16·tm rows needs before it is taken (tallest first):
#: 64-row and 128-row tiles two on each of the H100's 132 SMs, 32-row tiles
#: 64 (at the GP's 64 × 2500, 72 × 2500 and 512 × 512 they beat 16-row
#: tiles; ``tools/kernel_timing.py --sweep`` times every tm)
TARGET_BLOCKS = {8: 2 * 132, 4: 2 * 132, 2: 64, 1: 0}


def launch_plan(n: int, m: int, d: int) -> dict:
    """The launch plan of one call: ``tm`` rows per thread (8, 4, 2 or 1), the
    tile (16·tm rows × 64 columns, 256 threads), the grid, and the static
    shared bytes. The tallest tile whose grid has ``TARGET_BLOCKS[tm]``
    blocks; features are staged 32 at a time."""
    col_tiles = -(-m // COLS)
    for tm in (8, 4, 2, 1):
        blocks = col_tiles * -(-n // (SIDE * tm))
        if blocks >= TARGET_BLOCKS[tm]:
            break
    rows = SIDE * tm
    smem = 4 * (32 * (rows + 1) + 32 * (COLS + 4) + rows + COLS)
    return dict(tm=tm, threads=SIDE * SIDE, tile=(rows, COLS),
                grid=(col_tiles, -(-n // rows)), blocks=blocks,
                chunk=min(d, 32), smem_bytes=smem)


def pairdist_plain(x: torch.Tensor, y: torch.Tensor,
                   bandwidth: float | None = None) -> torch.Tensor:
    """The ‖a‖²+‖b‖²−2abᵀ form (``repro.kernels.backend.sqdist_xla`` /
    ``rbf_xla``). ``torch.maximum`` splits the gradient at a tie like
    ``jnp.maximum``, so autograd through it matches JAX's."""
    aa = torch.sum(x * x, dim=-1)
    bb = torch.sum(y * y, dim=-1)
    d2 = torch.maximum(aa[:, None] + bb[None, :] - 2.0 * (x @ y.T),
                       x.new_zeros(()))
    if bandwidth is None:
        return d2
    return torch.exp(-d2 / (2.0 * bandwidth * bandwidth + 1e-12))


def pairdist(x: torch.Tensor, y: torch.Tensor, *,
             bandwidth: float | None = None,
             differentiable: bool = False) -> torch.Tensor:
    global launches
    check_tensor("x", x, 2)
    check_tensor("y", y, 2)
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"pairdist: feature dims disagree (x has "
                         f"D={x.shape[1]}, y has D={y.shape[1]})")
    if differentiable or on_cpu(x, y):
        return pairdist_plain(x, y, bandwidth)
    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0 or m == 0:
        return out
    inv2s2 = 0.0 if bandwidth is None else \
        1.0 / (2.0 * float(bandwidth) ** 2 + 1e-12)
    err = build.library().pairdist_launch(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), n, m, d,
        int(bandwidth is not None), inv2s2, launch_plan(n, m, d)["tm"],
        build.stream_ptr(x))
    build.check(err, "pairdist")
    key = (n, m, d, "d2" if bandwidth is None else "rbf")
    with COUNT_LOCK:
        launches += 1
        shape_launches[key] = shape_launches.get(key, 0) + 1
    return out


def pairdist_chunked(x: torch.Tensor, y: torch.Tensor, *, chunk: int,
                     bandwidth: float | None = None) -> torch.Tensor:
    """:func:`pairdist` assembled from ``[N, chunk]`` column blocks: one
    launch a block on CUDA tensors, each block's columns bitwise the
    monolithic launch's (every element sums over the features only). On CPU
    tensors it is the one plain call: a BLAS product rounds by the shape of
    the whole call, so plain blocks would not be the monolithic result."""
    if chunk < 1:
        raise ValueError(f"pairdist_chunked: chunk must be >= 1, got {chunk}")
    m = y.shape[0]
    if chunk >= m or on_cpu(x, y):
        return pairdist(x, y, bandwidth=bandwidth)
    return torch.cat([pairdist(x, y[j:j + chunk], bandwidth=bandwidth)
                      for j in range(0, m, chunk)], dim=1)
