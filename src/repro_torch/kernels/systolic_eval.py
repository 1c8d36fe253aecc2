"""``systolic_eval``: the batched SoC cost model (kernel K1).

:func:`soc_metrics` evaluates ``vals`` [N, 26] against ``layers`` [L, 5] and
returns [N, 3] (latency ms, power mW, area mm²). On a CPU tensor it runs the
plain version (:func:`soc_metrics_plain`, the [N, L]-broadcast PyTorch
model); on a CUDA tensor it launches ``csrc/systolic_eval.cu`` with the plan
of :func:`launch_plan`, or raises.

:func:`soc_metrics_multi` is the multi-workload entry (the fleet's fused
flush): ``vals`` [W, n, 26] against ``layers`` [W, Lmax, 5] padded to a
common depth under a prefix ``layer_mask`` [W, Lmax] -> [W, n, 3], one launch
whose grid spans (design tile, workload); its plain version is
:func:`soc_metrics_multi_plain`. Workload w's slice is bitwise a single
:func:`soc_metrics` launch on its own L_w layers.
"""
from __future__ import annotations

import torch

from repro_torch.soc.model import metrics_multi as soc_metrics_multi_plain
from repro_torch.soc.model import metrics_tile as soc_metrics_plain

from . import build
from ._common import COUNT_LOCK, check_tensor, on_cpu

__all__ = ["soc_metrics", "soc_metrics_plain", "soc_metrics_multi",
           "soc_metrics_multi_plain", "launch_plan", "launches",
           "shape_launches", "multi_shape_launches"]

#: kernel launches since the count was last set to 0 (single and multi)
launches = 0
#: the single-workload launches by shape: (designs, layers) -> count
shape_launches: dict = {}
#: the multi-workload launches by shape: (workloads, designs, Lmax) -> count
multi_shape_launches: dict = {}

#: the layer table, staged once per block, may fill 48 KB
MAX_LAYERS = (48 * 1024) // (5 * 4)
N_FEATURES = 26
#: dynamic shared memory a Hopper block may opt into, and threads a block
SMEM_LIMIT, MAX_THREADS = 232_448, 128
#: layers a lane may keep in registers (the kernel's instances)
REGISTER_LAYERS = (1, 2, 4)
#: streaming multiprocessors of an H100, and the warps an SM should have
#: before a design takes fewer lanes than layers
SMS, THROUGHPUT_WARPS = 132, 4


def _pow2(x: int) -> int:
    """The smallest power of two ≥ x (x ≥ 1)."""
    return 1 << max(0, x - 1).bit_length()


def launch_plan(n: int, n_layers: int, g: int | None = None,
                workloads: int = 1) -> dict:
    """The launch plan of one call: ``g`` lanes a design; ``kr`` layers a
    lane in registers (1, 2 or 4; 0 keeps them in shared memory);
    ``threads`` a block (1–4 warps: one warp a block until the designs fill
    the card, so a few designs spread over SMs); the odd ``stride`` of the
    per-design arrays (3 of them, 5 with ``kr`` 0); the dynamic shared
    bytes (the [L, 5] table and each design's arrays).

    ``g`` (a power of two, 4–32; default the plan's, which always fits; a
    forced ``g`` whose warp of designs does not fit raises): for a few
    designs as many lanes as layers, up to a warp, so a design's chain is
    short; once the designs fill ``THROUGHPUT_WARPS`` warps an SM even at
    fewer lanes, the fewest lanes that hold every layer in registers (4 a
    lane), so the sums, decode and epilogue of several designs share a
    warp's issue."""
    few = min(32, max(4, _pow2(n_layers)))
    if g is None:
        many = min(few, max(4, _pow2(-(-n_layers // max(REGISTER_LAYERS)))))
        g = many if n >= SMS * THROUGHPUT_WARPS * (32 // many) else few
    if g not in (4, 8, 16, 32):
        raise ValueError(f"systolic_eval: {g} lanes a design; 4, 8, 16 or 32")
    per_lane = -(-n_layers // g)
    kr = next((k for k in REGISTER_LAYERS if per_lane <= k), 0)
    stride = n_layers | 1
    arrays = 3 if kr else 5
    per_warp = 32 // g
    warps = workloads * -(-n // per_warp)
    wb = min(MAX_THREADS // 32, max(1, warps // SMS))

    def smem(wb):
        return 4 * (5 * n_layers + wb * per_warp * arrays * stride)

    while wb > 1 and smem(wb) > SMEM_LIMIT:
        wb -= 1
    if smem(wb) > SMEM_LIMIT:  # only a forced g: the default always fits
        raise ValueError(f"systolic_eval: {g} lanes a design at {n_layers} "
                         f"layers need {smem(wb)} bytes of shared memory")
    designs = wb * per_warp
    blocks = -(-n // designs)
    return dict(g=g, g_log2=g.bit_length() - 1, kr=kr, threads=32 * wb,
                designs_per_block=designs, blocks=blocks,
                grid=(blocks, workloads), stride=stride, smem_bytes=smem(wb))


def soc_metrics(vals: torch.Tensor, layers: torch.Tensor) -> torch.Tensor:
    global launches
    check_tensor("vals", vals, 2)
    check_tensor("layers", layers, 2)
    if vals.shape[1] != N_FEATURES or layers.shape[1] != 5:
        raise ValueError(f"systolic_eval: expected vals [N, {N_FEATURES}] and "
                         f"layers [L, 5], got {tuple(vals.shape)} and "
                         f"{tuple(layers.shape)}")
    if on_cpu(vals, layers):
        return soc_metrics_plain(vals, layers)
    n, n_layers = vals.shape[0], layers.shape[0]
    if not 0 < n_layers <= MAX_LAYERS:
        raise ValueError(f"systolic_eval: 1..{MAX_LAYERS} layers supported, "
                         f"got {n_layers}")
    out = torch.empty((n, 3), dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    p = launch_plan(n, n_layers)
    err = build.library().systolic_eval_launch(
        vals.data_ptr(), layers.data_ptr(), out.data_ptr(), n, n_layers,
        p["g_log2"], p["kr"], p["threads"], p["stride"], p["smem_bytes"],
        build.stream_ptr(vals))
    build.check(err, "systolic_eval")
    with COUNT_LOCK:
        launches += 1
        shape_launches[(n, n_layers)] = \
            shape_launches.get((n, n_layers), 0) + 1
    return out


def soc_metrics_multi(vals: torch.Tensor, layers: torch.Tensor,
                      layer_mask: torch.Tensor) -> torch.Tensor:
    """W workloads in one launch: ``vals`` [W, n, 26], ``layers``
    [W, Lmax, 5], ``layer_mask`` [W, Lmax] (a prefix of 1.0 on each
    workload's layers, as ``soc.workloads.pad_workloads`` builds it) ->
    [W, n, 3]. The plain version on CPU tensors; on CUDA tensors one kernel
    launch, which counts each workload's layers from its mask row (a row
    that is not a prefix of ones gives NaN outputs), or raises."""
    global launches
    check_tensor("vals", vals, 3)
    check_tensor("layers", layers, 3)
    check_tensor("layer_mask", layer_mask, 2)
    W, n, f = vals.shape
    if f != N_FEATURES or layers.shape[0] != W or layers.shape[2] != 5 \
            or tuple(layer_mask.shape) != tuple(layers.shape[:2]):
        raise ValueError(
            f"systolic_eval: expected vals [W, n, {N_FEATURES}], layers "
            f"[W, Lmax, 5] and layer_mask [W, Lmax], got {tuple(vals.shape)}"
            f", {tuple(layers.shape)} and {tuple(layer_mask.shape)}")
    if on_cpu(vals, layers, layer_mask):
        return soc_metrics_multi_plain(vals, layers, layer_mask)
    lmax = layers.shape[1]
    if not 0 < lmax <= MAX_LAYERS or not 0 < W <= 65535:
        raise ValueError(f"systolic_eval: 1..{MAX_LAYERS} layers and "
                         f"1..65535 workloads supported, got {lmax} and {W}")
    out = torch.empty((W, n, 3), dtype=torch.float32, device=vals.device)
    if n == 0:
        return out
    p = launch_plan(n, lmax, workloads=W)
    err = build.library().systolic_eval_multi_launch(
        vals.data_ptr(), layers.data_ptr(), layer_mask.data_ptr(),
        out.data_ptr(), W, n, lmax, p["g_log2"], p["kr"], p["threads"],
        p["stride"], p["smem_bytes"], build.stream_ptr(vals))
    build.check(err, "systolic_eval (multi)")
    key = (W, n, lmax)
    with COUNT_LOCK:
        launches += 1
        multi_shape_launches[key] = multi_shape_launches.get(key, 0) + 1
    return out
