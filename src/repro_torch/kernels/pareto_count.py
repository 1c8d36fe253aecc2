"""``pareto_count``: strict-dominance counts for minimization (kernel K3).

:func:`dominance_counts` returns, for each row of ``y`` [N, m] (float32),
the number of rows q with all(q <= p) and any(q < p), as int32 [N]. On a
CPU tensor it runs :func:`dominance_counts_plain`; on a CUDA tensor it
launches ``csrc/pareto_count.cu`` with the plan of :func:`launch_plan`, or
raises.
"""
from __future__ import annotations

import torch

from . import build
from ._common import COUNT_LOCK, check_tensor, on_cpu

__all__ = ["dominance_counts", "dominance_counts_plain", "launch_plan",
           "launches", "shape_launches"]

#: kernel launches since the count was last set to 0
launches = 0
#: the same launches by class: "small" (a round's front, up to
#: ``FRONT_ROWS`` rows) or "large"
shape_launches: dict = {}

MAX_OBJECTIVES = 8
#: threads a block may have; the most rows of a call planned as a round's
#: front
MAX_THREADS, FRONT_ROWS = 1024, 128
#: a round's front: blocks of this many rows, 2 rows a row thread and this
#: many splits (128 threads)
SMALL_ROWS, SMALL_SPLITS = 16, 16
#: a larger call: splits a row thread (4 rows each), and the H100's SMs
LARGE_SPLITS, SMS = 128, 132
#: shared bytes of staged rows j a block may take (the kernel stages tiles
#: of this many bytes where y is larger)
TILE_BYTES = 96 * 1024


def launch_plan(n: int, m: int, per_sm: int = 1, splits: int | None = None,
                block_rows: int | None = None) -> dict:
    """The launch plan of one call. Up to ``FRONT_ROWS`` rows (a round's
    front): blocks of ``block_rows`` rows (default ``SMALL_ROWS``), 2 rows
    a row thread. Beyond: about ``per_sm`` blocks an SM (at least
    ``SMALL_ROWS`` rows a block), each a run of ``rows_per_block``
    consecutive rows, so the SMs share the pairs evenly, 4 rows a row
    thread (2 for m > 4). Each row thread has ``splits`` S (a
    power of two; default ``SMALL_SPLITS`` / ``LARGE_SPLITS``) walking the
    j range; row threads are rounded up to whole warps, and ``threads`` =
    A·S ≤ 1024. Rows j are staged ``tile_rows`` at a time, each padded to
    ``pad`` = 4 or 8 floats; ``smem_bytes`` holds the tile and the warps'
    sums."""
    pad = 4 if m <= 4 else 8
    if n <= FRONT_ROWS:
        r, rows = 2, min(n, block_rows or SMALL_ROWS)
        s = splits or SMALL_SPLITS
    else:
        r = 4 if m <= 4 else 2
        k = per_sm
        while -(-n // (SMS * k)) > 32 * r:  # at most 32 row threads
            k += 1
        rows = max(SMALL_ROWS, -(-n // (SMS * k)))
        s = splits or LARGE_SPLITS
    a = -(-rows // r)
    while a * s > MAX_THREADS:
        s //= 2
    if s < 32:
        a = -(-a // (32 // s)) * (32 // s)  # whole warps
    tile = max(1, min(n, TILE_BYTES // (4 * pad)))
    return dict(rows_per_block=rows, rows_per_thread=r, row_threads=a,
                splits=s, s_log2=s.bit_length() - 1, threads=a * s,
                blocks=-(-n // rows), pad=pad, tile_rows=tile,
                tiles=-(-n // tile),
                smem_bytes=4 * (pad * tile + -(-s // 32) * r * a))


def dominance_counts_plain(y: torch.Tensor) -> torch.Tensor:
    """The [N, N, m] broadcast form (``dominance_counts_xla``)."""
    le = torch.all(y[:, None, :] <= y[None, :, :], dim=-1)  # le[q, p]: q <= p
    lt = torch.any(y[:, None, :] < y[None, :, :], dim=-1)
    return torch.sum(le & lt, dim=0, dtype=torch.int32)


def dominance_counts(y: torch.Tensor) -> torch.Tensor:
    global launches
    check_tensor("y", y, 2)
    if on_cpu(y):
        return dominance_counts_plain(y)
    n, m = y.shape
    if not 0 < m <= MAX_OBJECTIVES:
        raise ValueError(f"pareto_count: 1..{MAX_OBJECTIVES} objectives "
                         f"supported, got {m}")
    out = torch.empty((n,), dtype=torch.int32, device=y.device)
    if n == 0:
        return out
    p = launch_plan(n, m)
    err = build.library().pareto_count_launch(
        y.data_ptr(), out.data_ptr(), n, m, p["rows_per_thread"],
        p["rows_per_block"], p["s_log2"], p["threads"], p["tile_rows"],
        p["smem_bytes"], build.stream_ptr(y))
    build.check(err, "pareto_count")
    key = "small" if n <= FRONT_ROWS else "large"
    with COUNT_LOCK:
        launches += 1
        shape_launches[key] = shape_launches.get(key, 0) + 1
    return out
