#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Builds the port's CUDA kernels (``src/repro_torch/csrc``) with ``nvcc``,
holds each kernel against its plain PyTorch version on the card at the main
path's shapes and times both, then drives the two main paths — a
paper-protocol ``soc_tuner`` run (n_pool=2500, resnet50, T=20, n=30, b=20,
gp_steps=150, 10 frontier samples over a 512-row subset) with its reference
front, first with the exact engine, then with the incremental one
(``incremental=True``: warm fits, block Cholesky updates, the
``round_fused`` kernel) — and checks that every kernel of each path was
launched in it and that its results are right. Then: the incremental run
with ``pool_chunk=512`` picks the same rows; the exact and the incremental
round, stage by stage, with the device's busy share; and at n_pool=64 the
card's picks equal the CPU's (exact, incremental, and q=2 fantasy batches).

The fleet: ``fleet_tuner`` over six scenarios (resnet50, mobilenet and
transformer x seeds 0 and 1, each at the paper protocol), exact and
incremental, with every count set to 0 before each run: each scenario's
final ADRS, the seconds a fleet round, the cache, K1's launches by shape
(single and multi-workload) and K4's a round (6 in every incremental round,
or it fails); one more fleet round of each under torch.profiler beside six
``soc_tuner`` rounds, and the launches of one Adam step for one and for six
scenarios; a fleet of one (resnet50, seed 0, the main path's draws) whose
rows and ADRS equal the main runs' bit for bit; and at n_pool=64 the card's
fleet picks equal the CPU's. K1's multi-workload entry is held against its
plain version at 3 x {60, 40, 2, 2500} designs (``K1_MULTI_SHAPES``), each
workload's slice bitwise a single launch.

The fleet over a mesh (``fleet_tuner(mesh=...)``): the same six scenarios,
incremental, over ``Mesh`` on axis ("fleet",) of 1, 2 and 3 scenario
groups (the card repeated; one group a card where several are visible),
every count set to 0 before each run: K4 6 launches in every round, K1's
multi-workload entry, K2 and K3 launched, the 2- and 3-group runs' rows
and metrics equal to the one-group run's (the whole fleet under the
mesh's fleet-wide refactor decision), and all equal to the unsharded
incremental fleet's where that run had no mixed round; the seconds of a
fleet round under each mesh beside the unsharded run's.

The LM serving path: ``flash_attn`` (K5; bf16 inputs take its tensor-core
route, ``csrc/flash_attn_tc.cu``, whose ptxas registers and spills and whose
``wgmma`` and TMA instructions in the built SASS are printed first) against
its plain version at the main path's shape, at S = 4096 and at a ragged
S = 2000, at the MLA prefills of minicpm3-4b (q·k head dim 96, v head
dim 64, 40 heads) and deepseek-v2-lite-16b (192, 128, 16 heads), and at
recurrentgemma-9b's (256, 256; 16 heads on one KV head) with its window
of 2048, without it and at a window of 100, timed beside
``scaled_dot_product_attention`` (a window as its explicit boolean
``attn_mask``); then
``mistral-nemo-12b`` at full width
(40 layers, d_model 5120, 32 heads / 8 KV heads, vocab 131072; random bf16
weights from a seed) serving ``Engine.generate`` at batch 4, a 2048-token
prompt and 16 greedy tokens, with exactly 40 K5 launches in the prefill,
all on the tensor-core route;
the same prefill again with K5's plain version passed in, its logits, its
teacher-forced decode logits and its greedy tokens held against the kernel
run's, and two planted attention faults that those checks must reject;
then the same for ``minicpm3-4b`` (MLA) at its published width and depth
(62 layers, d_model 2560, 40 heads, kv_lora 256, q_lora 768, q·k 64 + 32
rope dims, v 64; 4.26 B parameters): 62 K5 launches in the prefill, the
absorbed decode over the latent cache, and two planted MLA faults (the
rope key dropped from k, v sliced at offset 0); then the MoE family the
same way: ``deepseek-v2-lite-16b`` at its published width and depth (27
layers, a dense layer 0, then 64 routed experts top-6 and 2 shared; MLA
at q·k 192 / v 128; 15.7 B parameters): 27 K5 launches at (192, 128) in
the prefill, the two MLA faults; and ``phi3.5-moe-42b-a6.6b`` at its
published width cut to 24 of its 32 layers (16 experts top-2, GQA 32/8;
31.5 B parameters: all 32 layers would not fit the 80 GB card): 24 K5
launches, the two GQA faults; then the SSM and hybrid families:
``mamba2-370m`` at its published width and depth (48 Mamba-2 layers,
d_model 1024; 0.37 B parameters): no K5 launch, and its chunked SSD
prefill against its recurrent decode (96 tokens; end to end printed,
checked block by block); and ``recurrentgemma-9b`` (38 layers: 12 groups
of two RG-LRU layers and a windowed attention layer, a tail of two RG-LRU
layers; d_model 4096, 16 heads on one KV head of 256, window 2048; 9.57 B
parameters) at a 4096-token prompt, past its window: 12 K5 launches at
(256, 256) with the window, the prefill's K/V handed to the 2048-slot ring,
decode wrapping it, and two planted window faults (no window; the window
halved to 1024); then ``whisper-tiny`` at its published width and depth
(4 encoder layers over random frame embeddings [4, 1500, 384], 4 decoder
layers with cross-attention, vocab 51865) at a 416-token prompt and
max_len 448: 8 K5 launches a prefill (the encoder's 4 with
``causal=False``), the encoder made causal and cross-attention reading
the previous layer's cross K/V as planted faults, and the decoder's mask
shifted by a key, which 4 layers do not carry to the logits past the
tolerances, held against K5 at the decoder's shape instead; and
``pixtral-12b`` (mistral-nemo's backbone) with random patch embeddings in
the first 1024 of its 2048 prompt slots: 40 K5 launches, the GQA faults,
and its logits without the patches past the tolerances. Before the serve
phases K5 with ``causal=False`` is held against its plain version on both
routes (whisper's encoder shape, ragged S 65 and 100, S 1536; zero keys
past S taking softmax mass as a planted fault, rejected at 65 and 100),
timed beside ``scaled_dot_product_attention(is_causal=False)``. An MoE
phase records every layer's expert
choices and prints the assignments dropped past capacity in the prefill,
the share of choices that differ between the kernel and the plain run and
the end-to-end differences (again with the kernel run's choices replayed
where its own took the plain run outside the tolerances); it is checked
layer by layer (``moe_forced_check``): each block on the kernel run's
input to it with K5's plain version (and with each fault), through the
final norm and the head at every position, at the serve tolerances. One
MoE layer of deepseek-v2-lite-16b at
full width on a float32 input of 2048 tokens (capacity 240: experts
overflow), card against CPU: equal expert choices, slots and drops,
outputs within ``MOE_F32_RTOL``, two planted MoE faults rejected (slots
in reverse arrival order, gates not renormalized), and two bf16 runs on
the card bitwise equal. Last, each smoke config's (mistral-nemo-12b@smoke,
minicpm3-4b@smoke, phi3.5-moe-42b-a6.6b@smoke, deepseek-v2-lite-16b@smoke,
mamba2-370m@smoke, recurrentgemma-9b@smoke, whisper-tiny@smoke,
pixtral-12b@smoke; the MLA ones through K5 at the
zero-padded dims (32, 16), recurrentgemma's at a window of 32 that the
75-token prompt passes) prefill and decode step on the card against the
CPU's.

The mutable pool and the between-round proposer: K4's two pool uses
against their plain versions (the refresh of 1 and 3 dirty chunks of a
5 x 512 pool and of the main path's one chunk, each bitwise the same chunks
of a full s0 = 0 launch; the scores at the main path's shape and at
16 x 16,384, the argmax of the scores the launch's pick); the paper-protocol
``soc_tuner`` with ``proposer={"enabled": True}`` (K4 by class: 20 rounds,
20 ``scores``, a ``refresh`` a step that replaced something; K3 20 more
launches than without it; s/round beside the proposer-less run; the seconds
of one proposal step); the proposer off, bit for bit the main incremental
run; a run cut at round 10 and resumed from its checkpoint, bit for bit the
uninterrupted one, for ``soc_tuner`` and the six-scenario fleet with the
proposer on (6 ``scores`` launches a step); and at n_pool=64 the card's
picks, victims and live pool equal the CPU's, for both drivers.

The exploration service (the paper protocol, nothing cut): ``service_tuner``
with q = 1 and the inline executor, bit for bit the main incremental run
with the same launches by shape and class; q = 1 and q = 4 (min_done 1,
ordered) over ``DelayedFlow(VLSIFlow(cuda), 1.0 s)``, q = 4 over four
worker threads and over four spawn processes (their rows equal; wall time
against q = 1; K4's launches split into refills and fantasy steps; K1's
launches here, one a dispatch in the thread run, the workers' own in the
process run); ``fleet_service`` over resnet50 and transformer at seed 0,
T 24 each, one 4-thread pool (ADRS and the cross-scenario dedup counts), and
at q = 1 inline against ``fleet_tuner(incremental=True)``'s picks; a
``TunerServer`` served on localhost with the ``server_two_jobs`` mix at
T 20, driven through ``request`` (submit, status, a ``metrics`` scrape
mid-run with ``engine_device_bytes`` > 0, shutdown), each job bit for bit
the job alone, and its cycle time; and the port's CLI in subprocesses,
SIGKILLed after 8 evaluations and resumed (bit for bit the uninterrupted
CLI run), a re-run on the filled flow cache that dispatches nothing, and
its event log rendered by ``build_chrome_trace``.

The paper's §IV comparison (the paper protocol, nothing cut): K3 at the
EHVI hypervolumes' fronts, K2 at microal's GP shapes and at the uncapped
TED's 4500 x 4500 against their plain versions (``pairdist_chunked``'s
4096-column blocks bitwise that launch); each of the six baselines once (``run_baseline``: final
ADRS beside the main runs', wall seconds, evaluations, launches by shape;
the five non-GP baselines must make K1 = T + 1 = 21 and K3 = T + 2 = 22
launches and 40 evaluations; microal's K3 launches must equal its
``pareto_mask`` calls, 2T + 2 fronts plus the masks inside its
``hypervolume`` calls, printed a round with the seconds spent in
``hypervolume``); at n_pool = 64 each baseline's card rows equal to its CPU
rows; ``ted_select(max_pool=None)`` at 4500 rows (one K2 launch, card
rows = CPU rows); Fig. 4(c): an exact ``soc_tuner`` over
``SimplifiedFlow`` (no K1 launch) with its front re-evaluated on the full
flow; Fig. 7(b): the main exact run's balanced optimum's
``area_breakdown``, whose parts times the NoC overhead must equal K1's
area.

``round_fused`` (K4) is held against its plain version at six shapes
(``K4_SHAPES``: the main path's refactor, block update and score-only
rounds, a 5 x 512 chunked pool at P = 256, and a 262,144-column pool
refactored and block-updated); ``pairdist`` (K2) at TED's shape and at
the GP's (``K2_SHAPES``); ``systolic_eval`` (K1) on resnet50 at 2500, 30
and 1 designs and on minicpm3-4b's 559-row table at 2500 (``K1_SHAPES``,
with a sha1 of each output); ``pareto_count`` (K3) at 2500 and 64 rows
with duplicates, a +inf row and a NaN (``K3_SHAPES``). The main runs print
K1's and K2's launches by shape and K3's and K4's by class, and check
K1's and K3's against the protocol's; the build report gives the K1-K4
kernels' registers, spills and shared memory, and their plans.

Training, after the serve phases: K5's backward (``csrc/flash_attn_bwd.cu``:
causal, with a window or without the causal mask, at every head-dim pair
of the forward, (16, 16), (64, 64), (128, 128), (256, 256) and MLA's (96,
64), (192, 128) and (32, 16); two launches, dQ then dK/dV,
``wgmma`` on TMA tiles; GQA's dk/dv summed over each KV head's query heads
in a fixed order), its two kernels' registers, spills, shared memory and
HGMMA/UTMALDG counts, then the backward against its plain version, and
the forward's row statistic (``lse``) against the plain logsumexp, at
starcoder2-3b's [2, 2048, 24/2, 128], qwen3-100m's [16, 128, 8/4, 64],
ragged [2, 100, 8/4, 64] and [2, 2000, 24/2, 128], [1, 4096, 32/8, 128],
the design's edges (16 query heads on one KV head, S 40, S 333, a
grid of fewer blocks than SMs) and pixtral-12b's and phi3.5-moe's [2,
2048, 32/8, 128] (``K5_BWD_SHAPES``), and at MLA's minicpm3-4b [2, 2048,
40/40, 96/64], deepseek-v2-lite-16b [2, 2048, 16/16, 192/128], ragged [1,
333, 16/16, 192/128] and the smoke dims' [2, 40, 4/4, 32/16] and [4, 64,
4/4, 32/16] (q·k 24 zero-padded, scale 1/√24; ``K5_BWD_MLA_SHAPES``),
timed beside the backward of ``scaled_dot_product_attention`` (both
replayed from a CUDA graph; the backend PyTorch picks printed), with a
tolerance scaled by
each 64-position tile's largest gradient and a mean bound, and a second
call bitwise equal to the first; four planted faults (D left out of dS,
the mask shifted by a key, the last key tile left out, lse off by 0.05
past S/2) rejected at every shape. Then qwen3-100m
(``examples/train_lm_torch.py``'s config) on the bigram stream for 50
steps with every count set to 0 just before
(12 K5 forward and 12 backward launches a step): the loss must fall by
>= 0.2 and stay above the bigram floor - 0.05; a run cut at step 20 and
resumed from its checkpoint ends bit for bit equal to the uninterrupted
one; its first 3 losses within 1e-3 of the CPU's, and its first step's
gradients leaf by leaf against the CPU's (a zero attention gradient
rejected). starcoder2-3b at its
published width: at 4 layers one step's gradients with K5 forward and
backward against the same step with the plain attention, leaf by leaf,
every leaf nonzero, and K5 on detached q/k/v (the autograd Function
bypassed) as a planted fault that leaves wq/wk/wv without a gradient;
then at all 30 layers (4.313 B parameters: float32 masters and moments,
the bf16 compute copy and its gradients on the card; B 2 x S 2048,
remat on): 3 timed steps (s a step, tokens/s, peak memory, the step's
parts, K5's 60 forward and 30 backward launches a step, the device's
busy share and time by kernel group). The vision, MLA and MoE families
at their published widths, cut in depth (``TRAIN_GRAD_FAMILIES``:
pixtral-12b at 4 layers with random patch embeddings in its 1024 patch
slots, minicpm3-4b at 4, phi3.5-moe-42b-a6.6b at 2, deepseek-v2-lite-16b
at its dense layer and 3 MoE layers): the same gradient check and
planted fault (every attention parameter but wo left without a
gradient), the MoE configs' expert choices recorded layer by layer in
the K5 run (the forward's and remat's rerun must be equal) and replayed
layer by layer in the plain and faulty runs; then minicpm3-4b at its
full depth (62 layers, 4.262 B parameters) and deepseek-v2-lite-16b cut
to 7 of 27 layers (``TRAIN_FULL_MLA``, ``TRAIN_FULL_MOE_MLA``) timed as
starcoder2-3b is (124 / 62 and 14 / 7 K5 launches a step; deepseek's
assignments past capacity a layer); and minicpm3-4b@smoke and
deepseek-v2-lite-16b@smoke trained through ``launch/train.py`` (K5 at
(32, 16): 2 forward and 1 backward launch a layer a step). The same
check, in the same loop (``k5_bwd_cases``), holds the backward without
the causal mask and with a window (``K5_BWD_MASK_SHAPES``:
whisper-tiny's encoder [2, 1500, 6/6, 64/64] and a ragged S 100,
recurrentgemma-9b's [1, 4096, 16/1, 256/256, W 2048] and [2, 1000, 16/1,
256/256, W 100], the smoke dims 16/16 at [4, 64, 4/2] under each mask)
against its plain version, timed beside SDPA's backward under the same
mask, with the planted faults under the mask (the last key tile, the
late lse, the window's lower bound off by a key, the ragged tile's zero
keys taking mass; ``K5_BWD_FAULT_UNSEEN`` names the one the tolerance
cannot see at S 1500). Then whisper-tiny whole (4 encoder and 4 decoder
layers, B 2 x S 448 over random frames [2, 1500, 384]) and
recurrentgemma-9b cut to 9 of 38 layers (B 1 x S 4096) with the same
gradient check and planted fault (``TRAIN_GRAD_NEW``), their timed steps
(recurrentgemma-9b's at 6 layers: at 9 AdamW ran out of memory) and
mamba2-370m's at full depth (B 2 x S 2048; every leaf's gradient
finite at the SSD's chunk of 256), K5's launches a step by mask; the
smoke twins of the dense, vision, phi3.5-moe, hybrid and SSM families
trained through ``launch/train.py`` and whisper-tiny's through
``make_train_step`` with frames (``TRAIN_SMOKE``), and the first step's
gradients of the SSM, hybrid and encoder-decoder twins on the card
against the CPU's.

Before training, K5 and its backward on query shards
(``check_flash_attn_query_shards``, ``K5_QSHARD_SHAPES``: qwen3-14b's
prefill_32k shard of 2048 of 32768 positions at offsets 30720, 0 and
14336, the train_4k shards of starcoder2-3b and minicpm3-4b, a window of
100 at an offset off the tiles, no causal mask): each shard against the
unsharded call's rows (bit for bit) and the plain version with the offset,
every piece of the sequence through the backward, their dq against the
unsharded rows and their dk/dv summed against the unsharded dk/dv, the
offset a tile short rejected forward and backward.

The sharded LM program, after training (``sharded_phase``): the
sequence-parallel check (``seq_parallel_check``: ``starcoder2-3b`` at
its published width cut to 4 layers, every attention layer's queries in
4 shards through ``_prefill_attention``'s query-shard branch, K5 at each
shard's offset forward and backward, in the prefill and the loss's
gradient, against the unsplit run: logits and every leaf within
TRAIN_GRAD's tolerances, only query-shard K5 launches); a one-rank
mesh (1, 1) of axes ("data", "model") over NCCL, in a subprocess with its
own store (``--sharded-worker``): ``starcoder2-3b`` at its published width
cut to 4 layers (``SHARDED``; B 2 x S 2048, remat) trained one step through
the sharded ``make_train_step`` (``constraint``, the ZeRO-1
redistributions, K5 and its backward on the local shards) and prefilled,
against the unsharded port on the same inputs: the loss, every leaf's
gradient, m, v, the masters and the prefill's logits bit for bit (or
within TRAIN_GRAD's tolerances, every differing leaf printed); K5's
launches (3 a layer in the step, with remat; 1 a layer in the prefill).
The host dry-runs four production cells over fake process groups of 256
or 512 ranks (``SHARDED_DRYRUN``: mistral-nemo-12b ``train_4k``
multi-pod, qwen3-14b ``prefill_32k`` sequence-parallel,
deepseek-v2-lite-16b ``decode_32k``, mamba2-370m ``long_500k``), one
``launch.dryrun`` process each at a lower priority, started with the
one-rank worker, after every timed phase; every record must be ``ok`` and
is printed.

It prints the card (``nvidia-smi``), the build time, one line per kernel
check, the rounds, the service, baselines, serve, training and sharded
phases, its wall time in all, a ``{"kernels": [...]}`` JSON line and, last, ``{"ok": true, "device":
{...}}``. Any failure raises; no phase is
caught. It needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
#: (non-tensor-core) operations/s. Roofline bounds are stated against these.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
#: bf16 dense tensor-core peak (the same data sheet): K5's bf16 inputs
PEAK_BF16_OPS_S = 989e12
#: float32 operations per (design, layer) pair of the SoC model, counted by
#: hand in repro_torch/soc/model.py (~101 in _layer_cost, ~28 in the
#: per-layer epilogue and sums); the per-design epilogue is negligible.
K1_OPS_PER_PAIR = 129
#: operations per (i, j) pair of dominance counting with m objectives:
#: m `<=` and m `<` compares, m + 1 logic ops, one add.
K3_OPS_PER_PAIR = lambda m: 3 * m + 2  # noqa: E731


def k4_ops(nc, C, d, m, P, S, s0, scoring=True) -> int:
    """float32 operations that one round_fused call needs at least (each +,
    -, *, / and each exp/erf/log one operation), whatever the kernel itself
    recomputes. With w = 1/ls² per objective: per column, d squares shared
    by the objectives; per column and objective, 2d for its w-weighted norm;
    per recomputed train row and objective, 3d to weight it and take its
    norm (once for all columns); per recomputed (row, column, objective),
    2d for the cross term, 6 for d² = a + b − 2c, its clamp, −½, exp and
    × var, and 2r + 1 for row r's substitution; when it scores (not a
    chunk refresh, whose pick is discarded), per column and objective, 4P
    for the moments, ~20 per frontier sample and ~8 more."""
    if s0 >= P:
        rbf = 0
    else:
        rbf = (nc * C * (d + 2 * d * m) + 3 * d * m * (P - s0)
               + nc * C * m * sum(2 * d + 6 + 2 * r + 1 for r in range(s0, P)))
    return rbf + (nc * C * m * (4 * P + 20 * S + 8) if scoring else 0)


def k4_bytes(nc, C, d, m, P, S, s0, use="round") -> int:
    """Bytes round_fused must move, each once. V: rows [0, s0) read and
    rows [s0, P) written (P rows in all, whatever s0). A call that
    recomputes rows (s0 < P) reads the pool chunks, L, x and ls. A
    ``refresh`` (s0 = 0 on gathered chunks, the pick discarded) needs
    nothing else but var; every other use scores, so reads beta, y*, the
    mask, var, y_mean, y_std and the weights and writes the pick, and
    ``scores`` also writes the [nc, C] scores."""
    n = nc * m * P * C
    if s0 < P:
        n += nc * C * d + m * P * P + P * d + m * d
    if use == "refresh":
        return 4 * (n + m)
    n += m * P + S * m + 4 * m + (nc * C if use == "scores" else 0)
    return 4 * n + nc * C + 4

MAIN = dict(n_pool=2500, workload="resnet50", T=20, n=30, b=20, gp_steps=150,
            s_frontiers=10, frontier_subset=512, seed=0)
SMALL = dict(n_pool=64, workload="resnet50", T=6, n=10, b=8, gp_steps=25,
             s_frontiers=10, frontier_subset=512, seed=3)
#: K4 shapes (nc, C, P, s0): the main path's one chunk of the 2500-row pool
#: at its final padded train size P = 72, refactored (s0 = 0), block-updated
#: (s0 = 64) and scored only (s0 = 72); a chunked pool of 5 x 512 columns
#: (ragged tail masked) at P = 256; and a large pool of 16 x 16,384 columns
#: (262,144 candidates, the chunked engine's scale), refactored and
#: block-updated.
K4_SHAPES = [(1, 2500, 72, 64), (1, 2500, 72, 0), (1, 2500, 72, 72),
             (5, 512, 256, 248), (16, 16384, 72, 0), (16, 16384, 72, 64)]
#: K4 shapes whose plain version is timed once (reps=1, repeats=1)
K4_LARGE = 100_000
#: K4's pool-edit refresh (nc, C, P, dirty chunks): the one chunk of the
#: main path's pool (a proposal step's refresh there), and 1 and 3 dirty
#: chunks of a 5 x 512 chunked pool
K4_REFRESH_SHAPES = [(1, 2500, 72, (0,)), (5, 512, 72, (2,)),
                     (5, 512, 72, (0, 2, 4))]
#: K4's pool scores (nc, C, P): the main path's pool (a proposal step's
#: scores) and 16 x 16,384 columns
K4_SCORES_SHAPES = [(1, 2500, 72), (16, 16384, 72)]
#: the between-round proposer on the main path: the reference's knobs
#: (every round, 4 candidates, scale 0.15), switched on
PROPOSER = {"enabled": True}
#: the round at which the resume checks cut a run
RESUME_CUT = 10
#: K2 shapes (n, m), D = 26: TED's 2500 x 2500 and a 64 x 2500 block (both
#: also in RBF mode), then the GP's calls at the main path's final P = 72:
#: the train block, the posterior over the pool, the joint samples over the
#: 512-row frontier subset and that subset with itself (d² mode, as
#: core/gp.py calls it).
K2_SHAPES = [(2500, 2500), (64, 2500), (72, 72), (72, 2500), (72, 512),
             (512, 512)]
K2_RBF_SHAPES = {(2500, 2500), (64, 2500)}
#: K1 shapes (workload, designs): resnet50's 54 layers at the reference
#: front's sweep (2500), the ICD trials (30) and a BO round's one design
#: (20 launches a run), and the 559-row table of minicpm3-4b
#: (``soc/workloads.py::from_arch_config``) at 2500 designs.
K1_SHAPES = [("resnet50", 2500), ("resnet50", 30), ("resnet50", 1),
             ("minicpm3-4b", 2500)]
#: the fleet phase: resnet50, mobilenet and transformer x seeds 0 and 1
#: (``benchmarks/fleet_sweep.py``'s default workloads and seed count), each
#: scenario at the paper protocol of ``MAIN`` (``benchmarks/common.py``)
FLEET_WORKLOADS = ("resnet50", "mobilenet", "transformer")
FLEET_SEEDS = (0, 1)
#: K1's multi-workload entry over ``FLEET_WORKLOADS`` (W = 3, Lmax = 54):
#: designs a workload at the fleet's flushes: the most the ICD trials of two
#: seeds can miss (60), the TED init (at most b = 20 a seed: 40), a round's
#: picks (2), and 2500 for timing
K1_MULTI_SHAPES = [60, 40, 2, 2500]
#: K3 shapes (rows, m = 3): the reference front and a round's front; and
#: the smallest and largest of the main path's round fronts (timed by
#: ``tools/kernel_timing.py``).
K3_SHAPES = [2500, 64]
K3_ROUND_FRONTS = [50, 70]
#: K3's planted rows: one all +inf, one with a NaN objective.
K3_INF_ROW, K3_NAN_ROW = 7, 11


def k1_inputs(dev, pool, workload: str, n: int):
    """K1's inputs: the first ``n`` designs of ``pool`` (TABLE I indices)
    as values [n, 26] and ``workload``'s layer table, on ``dev``."""
    import torch

    from repro_torch.core.space import make_space
    from repro_torch.soc.workloads import get_workload

    vals = torch.as_tensor(make_space().values(pool[:n]), dtype=torch.float32,
                           device=dev).contiguous()
    layers = torch.as_tensor(get_workload(workload), dtype=torch.float32,
                             device=dev).contiguous()
    return vals, layers


def k1_multi_inputs(dev, n: int):
    """K1 multi's inputs: ``n`` TABLE I designs a workload of
    ``FLEET_WORKLOADS`` (3n drawn with seed 4321) as values [3, n, 26], and
    the padded tables and mask (``pad_workloads``)."""
    import torch

    from repro_torch.core.space import make_space
    from repro_torch.soc.workloads import get_workload, pad_workloads

    W = len(FLEET_WORKLOADS)
    space = make_space()
    idx = space.sample(torch.Generator(device=dev).manual_seed(4321), W * n)
    vals = torch.as_tensor(space.values(idx.cpu().numpy()).reshape(W, n, -1),
                           dtype=torch.float32, device=dev).contiguous()
    layers, mask = pad_workloads([get_workload(w) for w in FLEET_WORKLOADS])
    return (vals, torch.as_tensor(layers, dtype=torch.float32, device=dev),
            torch.as_tensor(mask, dtype=torch.float32, device=dev))


def k1_pool(dev):
    """The 2500 TABLE I designs K1 is checked and timed on (seed 1234)."""
    import torch

    from repro_torch.core.space import make_space

    gen = torch.Generator(device=dev).manual_seed(1234)
    return make_space().sample(gen, 2500).cpu().numpy()


def k3_inputs(y_pool, n: int):
    """K3's input [n, 3] from the pool's metrics ``y_pool`` [2500, 3]: the
    first 4n/5 rows, then the first n/5 again (duplicates), with row
    ``K3_INF_ROW`` set to +inf and one objective of row ``K3_NAN_ROW`` to
    NaN."""
    import torch

    k = n // 5
    y = torch.cat([y_pool[:n - k], y_pool[:k]]).contiguous()
    y[K3_INF_ROW] = float("inf")
    y[K3_NAN_ROW, 1] = float("nan")
    return y


def tensor_sha1(t) -> str:
    """sha1 of a tensor's bytes (on the host), to show two runs agree
    bitwise."""
    import hashlib

    return hashlib.sha1(t.detach().cpu().contiguous().numpy().tobytes()
                        ).hexdigest()


def _event_ms(fn, repeats: int) -> float:
    """Median milliseconds of ``fn()`` over ``repeats`` CUDA-event windows."""
    import torch

    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def time_ms(fn, reps: int = 20, repeats: int = 7,
            stream=None) -> tuple[float, float]:
    """Per-call milliseconds of ``fn`` by CUDA events, median of ``repeats``
    windows of ``reps`` calls (warm L2): ``(device, eager)``. ``device``
    replays the calls from a CUDA graph, so the card runs them back to back
    and the time is the device's; ``eager`` issues them from Python, so it
    includes whatever the host adds between launches. ``stream`` (a side
    stream, not the default one) is where the graph is captured, where
    ``fn``'s work must run."""
    import torch

    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    graph.replay()
    device = _event_ms(graph.replay, repeats) / reps
    eager = _event_ms(lambda: [fn() for _ in range(reps)], repeats) / reps
    return device, eager


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_F32_OPS_S) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(results, name, shape, err, tol_ok, t_k, t_p, t_lib, bound,
            **extra):
    """Print and keep one kernel check; ``t_*`` are (device, eager) pairs
    from :func:`time_ms`; ``extra`` is kept beside them. Raises if the
    kernel disagreed."""
    lib = "n/a" if t_lib is None else f"{t_lib[0]:.4f}/{t_lib[1]:.4f} ms"
    print(f"  {name} {shape}: max_abs_err={err:.3e} ok={tol_ok} "
          f"device/eager: kernel={t_k[0]:.4f}/{t_k[1]:.4f} ms "
          f"plain={t_p[0]:.4f}/{t_p[1]:.4f} ms library={lib} "
          f"bound={bound[0]:.5f} ms ({bound[1]})")
    if not tol_ok:
        raise AssertionError(f"{name} {shape}: kernel disagrees with its "
                             f"plain version (max abs err {err:.3e})")
    results.setdefault(name, []).append(dict(
        shape=shape, max_abs_err=err, ms=t_k[0], plain_ms=t_p[0],
        library_ms=None if t_lib is None else t_lib[0],
        eager_ms=t_k[1], plain_eager_ms=t_p[1],
        library_eager_ms=None if t_lib is None else t_lib[1],
        bound_ms=bound[0], bound_by=bound[1], **extra))


def check_kernels(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.kernels import pairdist as K2
    from repro_torch.kernels import pareto_count as K3
    from repro_torch.kernels import systolic_eval as K1

    pool = k1_pool(dev)
    results = {}
    record = functools.partial(_record, results)

    # --- K1 systolic_eval at K1_SHAPES: resnet50's 54 layers at the
    # reference-front sweep (N=2500), the ICD trials (30) and a BO round's
    # one design, and minicpm3-4b's 559-row table at 2500 designs.
    for workload, n in K1_SHAPES:
        vals, layers = k1_inputs(dev, pool, workload, n)
        out_k = K1.soc_metrics(vals, layers)
        out_p = K1.soc_metrics_plain(vals, layers)
        torch.cuda.synchronize()
        # float32 sums over the L layers in another order (<= L*2^-24
        # relative in the worst case, ~sqrt(L)*2^-24 typically) plus
        # powf/log2f ulps: rtol 2e-5
        ok = bool(torch.allclose(out_k, out_p, rtol=2e-5, atol=0.0))
        err = float((out_k - out_p).abs().max())
        L = layers.shape[0]
        bnd = bound_ms(4 * (n * 26 + L * 5 + n * 3), n * L * K1_OPS_PER_PAIR)
        plan = K1.launch_plan(n, L)
        record("systolic_eval", [n, 26, L], err, ok,
               time_ms(lambda: K1.soc_metrics(vals, layers)),
               time_ms(lambda: K1.soc_metrics_plain(vals, layers)), None, bnd,
               workload=workload, sha1=tensor_sha1(out_k),
               plan={k: plan[k] for k in ("g", "kr", "threads", "blocks",
                                          "smem_bytes")})
        if (workload, n) == ("resnet50", 2500):
            y_pool = out_p

    # --- K1's multi-workload entry at the fleet's flush shapes (W = 3
    # workloads of n designs each, Lmax = 54): K1's tolerance against the
    # plain version, and each workload's slice bitwise a single launch on
    # its own table.
    from repro_torch.soc.workloads import get_workload

    for n in K1_MULTI_SHAPES:
        vals, layers, mask = k1_multi_inputs(dev, n)
        out_k = K1.soc_metrics_multi(vals, layers, mask)
        out_p = K1.soc_metrics_multi_plain(vals, layers, mask)
        singles = [K1.soc_metrics(vals[w], torch.as_tensor(
            get_workload(wl), dtype=torch.float32, device=dev))
            for w, wl in enumerate(FLEET_WORKLOADS)]
        torch.cuda.synchronize()
        bitwise = all(torch.equal(out_k[w], o) for w, o in enumerate(singles))
        ok = bitwise and bool(torch.allclose(out_k, out_p, rtol=2e-5, atol=0.0))
        err = float((out_k - out_p).abs().max())
        W, L = layers.shape[:2]
        real = int(mask.sum())  # the layers this input's sums run over
        bnd = bound_ms(4 * (W * n * 26 + W * L * 5 + W * L + W * n * 3),
                       n * real * K1_OPS_PER_PAIR)
        plan = K1.launch_plan(n, L, workloads=W)
        print(f"  systolic_eval_multi [{W}, {n}, 26, {L}]: each workload's "
              f"slice bitwise a single launch: {bitwise}")
        record("systolic_eval_multi", [W, n, 26, L], err, ok,
               time_ms(lambda: K1.soc_metrics_multi(vals, layers, mask)),
               time_ms(lambda: K1.soc_metrics_multi_plain(vals, layers, mask)),
               None, bnd, sha1=tensor_sha1(out_k),
               plan={k: plan[k] for k in ("g", "kr", "threads", "grid",
                                          "smem_bytes")})

    # --- K2 pairdist at K2_SHAPES, D = 26, in the d² mode the main path
    # uses and (for two of them) the fused RBF mode (tools/kernel_timing.py's
    # inputs).
    gen = torch.Generator(device=dev).manual_seed(1234)
    x_all = torch.rand((2500, 26), generator=gen, device=dev)
    for n, m in K2_SHAPES:
        x, y = x_all[:n].contiguous(), x_all.flip(0)[:m].contiguous()
        scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
        # cancellation in |x|^2+|y|^2-2xy: float32 error up to ~D*2^-24 of
        # the norms, so atol = 2*D*2^-24*scale
        atol = 2 * 26 * 2.0 ** -24 * scale
        bw = 1.3
        inv2s2 = 1.0 / (2 * bw * bw + 1e-12)
        modes = ((None, atol), (bw, inv2s2 * atol + 1e-6))
        for bandwidth, tol in modes[:2 if (n, m) in K2_RBF_SHAPES else 1]:
            out_k = K2.pairdist(x, y, bandwidth=bandwidth)
            out_p = K2.pairdist_plain(x, y, bandwidth)
            torch.cuda.synchronize()
            err = float((out_k - out_p).abs().max())
            ok = bool(torch.allclose(out_k, out_p, rtol=1e-5, atol=tol))
            ops = 2 * n * m * 26 + 3 * n * m + 2 * (n + m) * 26 \
                + (2 * n * m if bandwidth else 0)
            bnd = bound_ms(4 * ((n + m) * 26 + n * m), ops)
            lib = (time_ms(lambda: torch.cdist(x, y)) if bandwidth is None
                   else None)
            record("pairdist" if bandwidth is None else "pairdist_rbf",
                   [n, m, 26], err, ok,
                   time_ms(lambda: K2.pairdist(x, y, bandwidth=bandwidth)),
                   time_ms(lambda: K2.pairdist_plain(x, y, bandwidth)),
                   lib, bnd)

    # --- K3 pareto_count at K3_SHAPES: the reference front's N=2500 and a
    # round's front of 64 rows, m=3, each with duplicated rows (ties
    # dominate nothing), one +inf row and one row holding a NaN.
    for n in K3_SHAPES:
        yd = k3_inputs(y_pool, n)
        c_k = K3.dominance_counts(yd)
        c_p = K3.dominance_counts_plain(yd)
        torch.cuda.synchronize()
        ok = bool(torch.equal(c_k, c_p))  # integer counts: exactly equal
        err = float((c_k - c_p).abs().max())
        plan = K3.launch_plan(n, 3)
        record("pareto_count", [n, 3], err, ok,
               time_ms(lambda: K3.dominance_counts(yd)),
               time_ms(lambda: K3.dominance_counts_plain(yd)), None,
               bound_ms(4 * (n * 3 + n), n * n * K3_OPS_PER_PAIR(3)),
               plan={k: plan[k] for k in ("rows_per_block", "threads",
                                          "blocks", "smem_bytes")})
        # the NaN row is dominated by nothing, the +inf row by every row
        # with no NaN and no +inf
        assert int(c_k[K3_NAN_ROW]) == 0
        assert int(c_k[K3_INF_ROW]) == n - 2
    return results


K4_ARGS = ("ls", "var", "L", "V", "x", "beta", "ystar", "pool_c", "evalm_c",
           "y_mean", "y_std", "weights")


def k4_problem(dev, nc, C, d, P, m=3, S=10, seed=0) -> dict:
    """A round_fused problem on the card, made with numpy from ``seed``:
    SPD Cholesky factors, a V consistent with them (the plain version at
    s0 = 0), frontier maxima, 3 evaluated columns and, where nc·C exceeds
    the main path's pool (a chunking of those 2500 rows), the ragged tail
    masked as the engine masks pad columns; a larger pool is its own size,
    every column live."""
    import numpy as np
    import torch

    from repro_torch.kernels import round_fused as K4

    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, P, P)) / np.sqrt(P)
    evalm = np.zeros((nc, C), bool)
    evalm[0, :3] = True
    if nc * C < 2 * MAIN["n_pool"]:
        evalm.reshape(-1)[MAIN["n_pool"]:] = True
    sc = 1.5 / np.sqrt(d)  # kernel entries O(0.1), as in the engine's rounds
    p = dict(ls=np.exp(0.3 * rng.normal(size=(m, d))),
             var=np.exp(0.2 * rng.normal(size=(m,))),
             L=np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(P)),
             V=np.zeros((nc, m, P, C)), x=sc * rng.normal(size=(P, d)),
             beta=rng.normal(size=(m, P)), ystar=rng.normal(size=(S, m)),
             pool_c=sc * rng.normal(size=(nc, C, d)), evalm_c=evalm,
             y_mean=np.linspace(-1, 1, m), y_std=np.linspace(0.5, 2, m),
             weights=np.linspace(0.2, 1, m))
    t = {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32),
                            device=dev) for k, v in p.items()}
    K4.round_select_plain(*(t[k] for k in K4_ARGS), s0=0)
    return t


def check_round_fused(dev, d: int, results: dict) -> None:
    """K4 against its plain version at ``K4_SHAPES``: equal picks, V within
    rtol = atol = 2e-5 (expf/erff/logf here against correctly rounded
    float64 ones there, through the substitution), V bitwise unchanged when
    s0 >= P. The plain version is timed once at a large pool (``K4_LARGE``
    columns or more)."""
    import torch

    from repro_torch.kernels import round_fused as K4

    m, S = 3, MAIN["s_frontiers"]
    for nc, C, P, s0 in K4_SHAPES:
        t = k4_problem(dev, nc, C, d, P, m, S, seed=nc * C + P + s0)
        a = {k: v.clone() for k, v in t.items()}
        b = {k: v.clone() for k, v in t.items()}
        va, ia = K4.round_select(*(a[k] for k in K4_ARGS), s0=s0)
        vb, ib = K4.round_select_plain(*(b[k] for k in K4_ARGS), s0=s0)
        torch.cuda.synchronize()
        err = float((va - vb).abs().max())
        ok = (int(ia) == int(ib)
              and bool(torch.allclose(va, vb, rtol=2e-5, atol=2e-5))
              and (s0 < P or bool(torch.equal(va, t["V"]))))
        print(f"  round_fused picks: kernel {int(ia)}, plain {int(ib)}")
        del b, vb
        args = [a[k] for k in K4_ARGS]
        bnd = bound_ms(k4_bytes(nc, C, d, m, P, S, s0),
                       k4_ops(nc, C, d, m, P, S, s0))
        plan = K4.launch_plan(nc, C, d, m, P, s0)
        large = nc * C >= K4_LARGE
        _record(results, "round_fused", [nc, C, d, m, P, S, s0], err, ok,
                time_ms(lambda: K4.round_select(*args, s0=s0),
                        reps=5 if large else 20, repeats=5 if large else 7),
                time_ms(lambda: K4.round_select_plain(*args, s0=s0),
                        reps=1 if large else 2, repeats=1 if large else 3),
                None, bnd, plan={k: plan[k] for k in K4.PLAN_KEYS
                                 + ("threads", "tiles")})
        del a, args, t
        torch.cuda.empty_cache()


def run_tuner(cfg: dict, device, draws=None, pool_device=None, **extra):
    """One soc_tuner run through the user's entry points; returns
    (result, pool, reference front, flow). The pool is sampled on
    ``pool_device`` (default: ``device``); ``extra`` goes to soc_tuner."""
    import torch

    from repro_torch.core import make_space, pareto_front, soc_tuner
    from repro_torch.soc import VLSIFlow

    space = make_space()
    gen = torch.Generator(device=pool_device or device).manual_seed(cfg["seed"])
    pool = space.sample(gen, cfg["n_pool"]).cpu().numpy()
    ref = pareto_front(VLSIFlow(space, cfg["workload"], device=device)(pool),
                       device=device)
    flow = VLSIFlow(space, cfg["workload"], device=device)
    kw = {k: cfg[k] for k in ("T", "n", "b", "gp_steps", "s_frontiers",
                              "frontier_subset")}
    res = soc_tuner(space, pool, flow, reference_front=ref,
                    seed=cfg["seed"], draws=draws, device=device, **kw,
                    **extra)
    return res, pool, ref, flow


def check_result(res, pool, ref, cfg) -> None:
    """The repo's own means: finite metrics of the right shape that the
    plain SoC model (on the CPU) reproduces, a full history, a finite ADRS
    that the Pareto front of the evaluated rows reproduces."""
    import numpy as np

    from repro_torch.core import adrs, make_space
    from repro_torch.soc import VLSIFlow

    rows = res.evaluated_rows
    assert len(rows) == len(set(rows.tolist())), "a row was evaluated twice"
    assert res.y.shape == (len(rows), 3) and np.isfinite(res.y).all()
    assert len(res.history) == cfg["T"] + 1
    assert res.engine_stats["rounds"] == cfg["T"]
    y_cpu = VLSIFlow(make_space(), cfg["workload"], device="cpu")(pool[rows])
    np.testing.assert_allclose(res.y, y_cpu, rtol=2e-5)
    final = res.history[-1]["adrs"]
    assert np.isfinite(final) and final >= 0.0
    np.testing.assert_allclose(final, adrs(ref, res.pareto_y), rtol=1e-12)


def _pool_icd(res, pool, dev):
    """The main path's pool in ICD space, as soc_tuner built it."""
    import torch

    from repro_torch.core import make_space
    from repro_torch.core.sampling import transform_to_icd

    pool_t = torch.as_tensor(pool, device=dev)
    return transform_to_icd(make_space(), res.space.apply_pins(pool_t),
                            res.v).contiguous()


def device_busy(fn, wall_s: float, groups: dict | None = None) -> dict:
    """Run ``fn`` once under torch.profiler, tracing the device alone: the
    device's busy seconds, its share of ``wall_s`` (an unprofiled run of
    the same work: the profiler slows the host, not the card), launches and
    the busiest kernels; with ``groups`` (name -> regex), the device
    seconds and launches of the kernels whose names match each, the first
    match winning, the rest under ``other``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in dev_events) * 1e-6
    launches = sum(e.count for e in dev_events)
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
    out = dict(device_busy_s=dev_s if launches else None,
               device_busy_share=dev_s / wall_s if launches else None,
               device_launches=launches,
               top_kernels=[(e.key[:60], e.count, e.self_device_time_total)
                            for e in top])
    if groups:
        by = {g: [0.0, 0] for g in list(groups) + ["other"]}
        for e in dev_events:
            g = next((g for g, rx in groups.items() if re.search(rx, e.key)),
                     "other")
            by[g][0] += e.self_device_time_total * 1e-6
            by[g][1] += e.count
        out["by_group"] = {g: dict(device_s=v[0], launches=v[1])
                           for g, v in by.items()}
    out["busy_text"] = (
        "device busy: not measured (the profiler saw no device activity)"
        if not launches else
        f"device busy {dev_s:.4f} s ({100 * out['device_busy_share']:.1f} % "
        f"of the wall time), {launches} launches")
    return out


def _print_top(out: dict) -> None:
    for name, count, us in out["top_kernels"]:
        print(f"    {us / 1e3:8.2f} ms {count:6d}x {name}")


def round_breakdown(res, pool, flow, cfg: dict, dev) -> dict:
    """One more exact round at the main path's final state, stage by stage:
    host-clock seconds (each stage ends in a synchronize) of the GP fit, the
    acquisition (posterior, frontier sampling, scoring) and one flow call;
    then the same round under torch.profiler (:func:`device_busy`)."""
    import torch

    from repro_torch.core import fit_gp, imoo_scores
    from repro_torch.random import GeneratorDraws

    pool_icd = _pool_icd(res, pool, dev)
    x = pool_icd[torch.as_tensor(res.evaluated_rows, device=dev)]
    y = torch.as_tensor(-res.y, device=dev)
    sub, eps = GeneratorDraws(1, dev).round(len(pool), cfg["frontier_subset"],
                                            3, cfg["s_frontiers"])
    fc = (pool_icd if sub is None
          else pool_icd[torch.as_tensor(sub, device=dev)].contiguous())

    def one_round() -> list[float]:
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        state = fit_gp(x, y, steps=cfg["gp_steps"])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        int(torch.argmax(imoo_scores(state, pool_icd, eps, frontier_cand=fc)))
        t.append(time.perf_counter())
        flow(pool[res.evaluated_rows[-1:]])
        t.append(time.perf_counter())
        return t

    t = one_round()
    out = dict(fit_s=t[1] - t[0], acquisition_s=t[2] - t[1],
               flow_s=t[3] - t[2], round_s=t[3] - t[0])
    out.update(device_busy(one_round, out["round_s"]))
    print(f"  one exact round, stage by stage: fit {out['fit_s']:.3f} s "
          f"({cfg['gp_steps']} Adam steps), acquisition "
          f"{out['acquisition_s']:.4f} s, flow {out['flow_s']:.4f} s, round "
          f"{out['round_s']:.3f} s; {out['busy_text']}")
    _print_top(out)
    return out


def incremental_breakdown(res, pool, cfg: dict, dev) -> dict:
    """Warm incremental rounds at the incremental main path's final state:
    an engine observes all but the last two evaluations, runs its cold
    round, observes one more, and then runs warm rounds. With
    ``profile_stages=True``: the seconds of each stage of one warm round
    (fit, factor, frontier, and its one round_fused launch, each ended by a
    synchronize). Without: one warm round's wall seconds (host clock, ending in a
    synchronize), its round_fused launches, and the same round under
    torch.profiler (:func:`device_busy`)."""
    import torch

    from repro_torch.core import BOEngine
    from repro_torch.core.engine import PROFILE_STAGES
    from repro_torch.kernels import round_fused as K4
    from repro_torch.random import GeneratorDraws

    pool_icd = _pool_icd(res, pool, dev)
    rows, y = res.evaluated_rows, res.y
    draws = GeneratorDraws(2, dev)

    def draw():
        return draws.round(len(pool), cfg["frontier_subset"], 3,
                           cfg["s_frontiers"])

    def warm_engine(**kw):
        eng = BOEngine(pool_icd, incremental=True, gp_steps=cfg["gp_steps"],
                       s_frontiers=cfg["s_frontiers"], device=dev, **kw)
        eng.observe(rows[:-2], y[:-2])
        sub, eps = draw()
        eng.select(eps, sub)
        eng.observe(rows[-2:-1], y[-2:-1])
        return eng

    eng = warm_engine(profile_stages=True)
    before = dict(eng.stats.stage_wall_s)
    sub, eps = draw()
    k4_before = K4.launches
    eng.select(eps, sub)
    if K4.launches != k4_before + 1:
        raise AssertionError("the profiled round launched round_fused "
                             f"{K4.launches - k4_before} times, not once")
    stages = {k: eng.stats.stage_wall_s[k] - before.get(k, 0.0)
              for k in PROFILE_STAGES + ("round_total",)}

    eng = warm_engine()
    sub, eps = draw()
    k4_before = K4.launches
    refactors = eng.stats.refactors

    def one_round():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.select(eps, sub)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = dict(stage_s=stages, round_s=one_round(),
               k4_launches_per_round=K4.launches - k4_before,
               refactored=eng.stats.refactors > refactors,
               P=eng._P, warm_steps=eng.warm_steps)
    out.update(device_busy(one_round, out["round_s"]))
    print(f"  one warm incremental round ({out['warm_steps']} Adam steps, "
          f"P={out['P']}, {'refactor' if out['refactored'] else 'block update'}"
          f"): {out['round_s']:.4f} s, {out['k4_launches_per_round']} "
          f"round_fused launch(es); {out['busy_text']}")
    print("  the same round in profile mode, stage by stage: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in stages.items()))
    _print_top(out)
    return out


class RoundProbe:
    """A scenario's draws that note K4's launch count (in all and by class)
    each time a round starts (``soc_tuner`` and ``fleet_tuner`` call
    ``round`` once a scenario at the top of every round): the differences
    are K4's launches a round, the proposal step after it included."""

    def __init__(self, draws):
        self.draws, self.k4_at_round, self.k4_class_at_round = draws, [], []

    def prologue(self, n_pool, n):
        return self.draws.prologue(n_pool, n)

    def round(self, n_pool, frontier_subset, m, s):
        from repro_torch.kernels import round_fused as K4

        self.k4_at_round.append(K4.launches)
        self.k4_class_at_round.append(dict(K4.class_launches))
        return self.draws.round(n_pool, frontier_subset, m, s)

    def propose(self, it, t, draw, p, d):
        return self.draws.propose(it, t, draw, p, d)

    def state_dict(self):
        return self.draws.state_dict()

    def load_state_dict(self, d):
        self.draws.load_state_dict(d)

    def class_per_round(self) -> list[dict]:
        """K4's launches by class in each round (with its proposal step)."""
        from repro_torch.kernels import round_fused as K4

        marks = self.k4_class_at_round + [dict(K4.class_launches)]
        return [{k: b[k] - a[k] for k in b} for a, b in zip(marks, marks[1:])]


def fleet_inputs(cfg: dict, device, pool_device=None):
    """The fleet's pool (as ``run_tuner`` samples it: the same seed gives
    the main path's pool) and each workload's reference front."""
    import torch

    from repro_torch.core import make_space, pareto_front
    from repro_torch.soc import VLSIFlow

    space = make_space()
    gen = torch.Generator(device=pool_device or device).manual_seed(cfg["seed"])
    pool = space.sample(gen, cfg["n_pool"]).cpu().numpy()
    fronts = {w: pareto_front(VLSIFlow(space, w, device=device)(pool),
                              device=device) for w in FLEET_WORKLOADS}
    return pool, fronts


def run_fleet(cfg: dict, device, scenarios, pool, fronts, draws=None,
              **extra):
    """One fleet_tuner run at ``cfg``'s protocol through the user's entry
    point; ``extra`` goes to fleet_tuner."""
    from repro_torch.core import FleetScenario, fleet_tuner, make_space

    kw = {k: cfg[k] for k in ("T", "n", "b", "gp_steps", "s_frontiers",
                              "frontier_subset")}
    return fleet_tuner(make_space(), pool,
                       [FleetScenario(w, seed=s) for w, s in scenarios],
                       reference_fronts=fronts, draws=draws, device=device,
                       **kw, **extra)


def adam_step_launches(dev, S: int, P: int = 72, d: int = 26, m: int = 3,
                       steps: int = 10) -> dict:
    """Device launches and wall seconds of one Adam step of the GP fit at
    the main path's final padded size, for one scenario (``gp._fit``) and
    for S scenarios folded into one loop (``gp._fit_batch``)."""
    import torch

    from repro_torch.core import gp

    gen = torch.Generator(device=dev).manual_seed(5)
    x = 0.3 * torch.randn((S, P, d), generator=gen, device=dev)
    y = torch.randn((S, P, m), generator=gen, device=dev)
    mask = torch.zeros((S, P), device=dev)
    p0 = gp.default_params(m, d, dev)
    batch = gp.GPParams(*(t.expand(S, *t.shape) for t in p0))
    out = {}
    for label, fn in (("one scenario", lambda: gp._fit(p0, x[0], y[0], mask[0],
                                                       steps=steps)),
                      (f"{S} scenarios", lambda: gp._fit_batch(
                          batch, x, y, mask, steps))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        busy = device_busy(fn, wall * steps)
        out[label] = dict(launches_per_step=busy["device_launches"] / steps,
                          wall_s_per_step=wall,
                          device_busy_share=busy["device_busy_share"])
    print("  one Adam step of the GP fit (P=72): " + "; ".join(
        f"{k}: {v['launches_per_step']:.1f} launches, "
        f"{1e3 * v['wall_s_per_step']:.3f} ms" for k, v in out.items()))
    return out


def fleet_breakdown(fr, pool, cfg: dict, dev, incremental: bool) -> dict:
    """One more fleet round at the fleet's final state on a fresh
    BatchedBOEngine (the exact round as is; the incremental one warm, after
    a cold round one evaluation earlier): its wall seconds (host clock,
    ending in a synchronize) and the same round under torch.profiler
    (:func:`device_busy`)."""
    import numpy as np
    import torch

    from repro_torch.core import BatchedBOEngine
    from repro_torch.random import GeneratorDraws

    pool_icd = torch.stack([_pool_icd(r, pool, dev) for r in fr.results])
    rows = [r.evaluated_rows for r in fr.results]
    ys = [r.y for r in fr.results]
    eng = BatchedBOEngine(pool_icd, incremental=incremental,
                          gp_steps=cfg["gp_steps"],
                          s_frontiers=cfg["s_frontiers"], device=dev)
    draws = [GeneratorDraws(2 + i, dev) for i in range(len(rows))]

    def draw():
        subs, eps = zip(*(d.round(len(pool), cfg["frontier_subset"], 3,
                                  cfg["s_frontiers"]) for d in draws))
        return list(eps), None if subs[0] is None else np.stack(subs)

    if incremental:
        eng.observe([r[:-2] for r in rows], [y[:-2] for y in ys])
        eng.select(*draw())
        eng.observe([r[-2:-1] for r in rows], [y[-2:-1] for y in ys])
    else:
        eng.observe([r[:-1] for r in rows], [y[:-1] for y in ys])
    eps, sub = draw()

    def one_round():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.select(eps, sub)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = dict(round_s=one_round(), P=eng._P)
    out.update(device_busy(one_round, out["round_s"]))
    print(f"  one {'warm incremental' if incremental else 'exact'} fleet "
          f"round ({len(rows)} scenarios, P={out['P']}): {out['round_s']:.4f} "
          f"s; {out['busy_text']}")
    _print_top(out)
    return out


def fleet_phase(dev, single: dict, card: str) -> dict:
    """The six-scenario fleet at the paper protocol, exact and incremental:
    each scenario's final ADRS and evaluations, the fleet round's seconds and
    busy share beside six soc_tuner rounds (``single``: the main path's round
    breakdowns), the cache, K1's launches by shape (single and multi) and
    K4's launches a round, which must be 6 on every incremental round.
    Each time is printed beside ``card`` (nvidia-smi's name and power
    limit)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import round_fused as K4
    from repro_torch.kernels import systolic_eval as K1
    from repro_torch.random import GeneratorDraws

    scen = [(w, s) for w in FLEET_WORKLOADS for s in FLEET_SEEDS]
    S, T = len(scen), MAIN["T"]
    pool, fronts = fleet_inputs(MAIN, dev)
    out = {"scenarios": [f"{w}:s{s}" for w, s in scen]}
    for label, inc in (("exact", False), ("incremental", True)):
        probe = RoundProbe(GeneratorDraws(scen[0][1], dev))
        draws = [probe] + [GeneratorDraws(s, dev) for _, s in scen[1:]]
        print(f"fleet ({label}): fleet_tuner, {S} scenarios",
              json.dumps({**MAIN, "workload": list(FLEET_WORKLOADS),
                          "seeds": list(FLEET_SEEDS), "incremental": inc}))
        kernels.reset_launches()
        t0 = time.perf_counter()
        fr = run_fleet(MAIN, dev, scen, pool, fronts, draws=draws,
                       incremental=inc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k4_rounds = np.diff(probe.k4_at_round + [K4.launches]).tolist()
        launches = {k.__name__.rsplit(".", 1)[1]: k.launches
                    for k in kernels.KERNELS}
        k1_single = {f"{n}x26x{L}": c for (n, L), c in
                     sorted(K1.shape_launches.items())}
        k1_multi = {f"{W}x{n}x26x{L}": c for (W, n, L), c in
                    sorted(K1.multi_shape_launches.items())}
        round_s = [h["wall_s"] for h in fr.results[0].history[1:]]
        for sc, res in zip(fr.scenarios, fr.results):
            check_result(res, pool, fronts[sc.workload],
                         {**MAIN, "workload": sc.workload})
            print(f"  {sc.label}: final ADRS {res.history[-1]['adrs']:.5f}, "
                  f"{len(res.evaluated_rows)} evaluations")
        print(f"  {label} [{card}]: {wall:.1f} s, {np.mean(round_s):.4f} s a "
              f"fleet round (median {np.median(round_s):.4f}), "
              f"{fr.cache.summary()}")
        print(f"  {label}: launches {launches}; systolic_eval single by "
              f"shape (designs x 26 x layers): {k1_single}, multi by shape "
              f"(workloads x designs x 26 x Lmax): {k1_multi}; round_fused "
              f"launches a round: {k4_rounds}")
        st = fr.results[0].engine_stats
        print(f"  {label}: engine rounds {st['rounds']}, refactors "
              f"{st['refactors']}, block updates {st['block_updates']}, mixed "
              f"rounds {st['mixed_rounds']}, scenario refactors "
              f"{st['scenario_refactors']}, scenario block updates "
              f"{st['scenario_block_updates']}")
        missing = [k for k in ("systolic_eval", "pairdist", "pareto_count")
                   + (("round_fused",) if inc else ()) if not launches[k]]
        if missing or not k1_multi:
            raise AssertionError(f"fleet ({label}): not launched: {missing}"
                                 + ("" if k1_multi else
                                    ", K1's multi-workload entry"))
        if inc and (k4_rounds != [S] * T or launches["round_fused"] != S * T):
            raise AssertionError(
                f"fleet ({label}): round_fused launched {k4_rounds} a round "
                f"({launches['round_fused']} in all), not {S} in each of {T}")
        if not inc and launches["round_fused"]:
            raise AssertionError("the exact fleet launched round_fused")
        brk = fleet_breakdown(fr, pool, MAIN, dev, inc)
        one = single[label]["round_s"]
        print(f"  {label} [{card}]: one fleet round {brk['round_s']:.4f} s against "
              f"{S} x {one:.4f} s = {S * one:.4f} s of soc_tuner rounds "
              f"({brk['round_s'] / (S * one):.3f} of them); fleet round "
              f"{brk['device_launches']} launches, a soc_tuner round "
              f"{single[label]['device_launches']}")
        out[label] = dict(
            rows=[r.evaluated_rows.tolist() for r in fr.results],
            y=[r.y.tolist() for r in fr.results],
            wall_s=wall, round_wall_s=round_s, breakdown=brk,
            single_round_s=one, launches=launches, systolic_eval=k1_single,
            systolic_eval_multi=k1_multi, round_fused_per_round=k4_rounds,
            cache=dict(requests=fr.cache.requests, hits=fr.cache.hits,
                       evaluated=fr.cache.evaluated,
                       flow_calls=fr.cache.flow_calls),
            final_adrs=fr.final_adrs(), engine_stats=st)
    print(f"  [{card}]", end="")
    out["adam_step"] = adam_step_launches(dev, S)
    return out


#: the mesh phase's scenario groups: the fleet over 1, 2 and 3 groups (one
#: group is the whole fleet under the mesh's fleet-wide refactor decision)
MESH_GROUPS = (1, 2, 3)


def mesh_phase(dev, fleet: dict, card: str) -> dict:
    """The six-scenario incremental fleet at the paper protocol over a
    ``Mesh`` on axis ("fleet",) of 1, 2 and 3 scenario groups (``dev``
    repeated; one group a card when more than one card is visible), every
    count set to 0 before each run: K4 must launch 6 times in every round,
    K1's multi-workload entry, K2 and K3 must launch. The one-group run is
    the whole fleet under the mesh's fleet-wide refactor decision; the 2-
    and 3-group runs must pick its rows and metrics, bit for bit (each
    group pads its GP work to the fleet's batch), and all must equal the
    fleet phase's unsharded incremental run (``fleet``) when that run had
    no mixed round (its per-scenario refactors then match the fleet-wide
    decision). The seconds of a fleet round under each mesh are printed
    beside the unsharded run's and ``card`` (nvidia-smi's name and power
    limit)."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import round_fused as K4
    from repro_torch.kernels import systolic_eval as K1
    from repro_torch.parallel import Mesh
    from repro_torch.random import GeneratorDraws

    scen = [(w, s) for w in FLEET_WORKLOADS for s in FLEET_SEEDS]
    S, T = len(scen), MAIN["T"]
    pool, fronts = fleet_inputs(MAIN, dev)
    base = fleet["incremental"]
    ncards = torch.cuda.device_count()
    out = {}
    for G in MESH_GROUPS:
        devs = ([dev] * G if ncards < 2 else
                [torch.device("cuda", g % ncards) for g in range(G)])
        mesh = Mesh(devs, ("fleet",))
        probe = RoundProbe(GeneratorDraws(scen[0][1], dev))
        draws = [probe] + [GeneratorDraws(s, dev) for _, s in scen[1:]]
        print(f"fleet over {mesh}: fleet_tuner, {S} scenarios, incremental")
        kernels.reset_launches()
        t0 = time.perf_counter()
        fr = run_fleet(MAIN, dev, scen, pool, fronts, draws=draws,
                       incremental=True, mesh=mesh)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k4_rounds = np.diff(probe.k4_at_round + [K4.launches]).tolist()
        launches = {k.__name__.rsplit(".", 1)[1]: k.launches
                    for k in kernels.KERNELS}
        k1_multi = sum(K1.multi_shape_launches.values())
        round_s = [h["wall_s"] for h in fr.results[0].history[1:]]
        st = fr.results[0].engine_stats
        for sc, res in zip(fr.scenarios, fr.results):
            check_result(res, pool, fronts[sc.workload],
                         {**MAIN, "workload": sc.workload})
        print(f"  {G} groups [{card}]: {wall:.1f} s, {np.mean(round_s):.4f} s "
              f"a fleet round (median {np.median(round_s):.4f}) against the "
              f"unsharded {np.mean(base['round_wall_s']):.4f} (median "
              f"{np.median(base['round_wall_s']):.4f}); launches {launches}, "
              f"systolic_eval multi {k1_multi}; round_fused launches a round: "
              f"{k4_rounds}; engine refactors {st['refactors']}, block "
              f"updates {st['block_updates']}, mixed rounds "
              f"{st['mixed_rounds']}, scenario refactors "
              f"{st['scenario_refactors']}")
        if k4_rounds != [S] * T or launches["round_fused"] != S * T:
            raise AssertionError(
                f"mesh ({G} groups): round_fused launched {k4_rounds} a "
                f"round, not {S} in each of {T}")
        missing = [k for k in ("systolic_eval", "pairdist", "pareto_count")
                   if not launches[k]] + ([] if k1_multi else
                                          ["systolic_eval multi"])
        if missing:
            raise AssertionError(f"mesh ({G} groups): not launched: "
                                 f"{missing}")
        out[G] = dict(devices=[str(d) for d in devs], wall_s=wall,
                      round_wall_s=round_s, launches=launches,
                      systolic_eval_multi=k1_multi,
                      round_fused_per_round=k4_rounds, engine_stats=st,
                      final_adrs=fr.final_adrs(),
                      rows=[r.evaluated_rows.tolist() for r in fr.results],
                      y=[r.y.tolist() for r in fr.results])
    a = out[1]
    for G in MESH_GROUPS[1:]:
        if out[G]["rows"] != a["rows"] or out[G]["y"] != a["y"]:
            raise AssertionError(f"the {G}-group mesh run picked other rows "
                                 "than the one-group run")
    mixed = base["engine_stats"]["mixed_rounds"]
    if mixed == 0:
        if a["rows"] != base["rows"] or a["y"] != base["y"]:
            raise AssertionError("the mesh runs' rows differ from the "
                                 "unsharded run's, which had no mixed round")
        held = "equal to the unsharded run (no mixed round there)"
    else:
        held = (f"not compared with the unsharded run: it had {mixed} mixed "
                "rounds, which a mesh decides fleet-wide")
    print(f"  mesh: {', '.join(map(str, MESH_GROUPS))} groups pick the "
          f"same rows and y; {held}")
    out["held"] = held
    return {str(k): v for k, v in out.items()}


def fleet_of_one(dev, main_runs: dict) -> None:
    """A fleet of [resnet50, seed 0] on the main path's draws (the default
    ``GeneratorDraws(0, cuda)``) and pool: its rows and final ADRS equal the
    main soc_tuner runs', bit for bit, exact and incremental."""
    import numpy as np

    pool, fronts = fleet_inputs(MAIN, dev)
    for label, inc in (("exact", False), ("incremental", True)):
        res = main_runs[label]
        one = run_fleet(MAIN, dev, [("resnet50", MAIN["seed"])], pool, fronts,
                        incremental=inc).results[0]
        compare_rows(f"fleet of one ({label}) rows", one, res)
        a, b = one.history[-1]["adrs"], res.history[-1]["adrs"]
        print(f"  fleet of one ({label}): final ADRS {a!r}, soc_tuner {b!r}")
        assert a == b, f"fleet of one ({label}): ADRS {a!r} != {b!r}"
        assert np.array_equal(one.y, res.y)


def fleet_card_vs_cpu() -> None:
    """At the golden size (``SMALL``; scenarios resnet50/0 and
    transformer/1), draws made once on the CPU and handed to both runs: the
    card's fleet picks equal the CPU's plain picks, exact and
    incremental."""
    import numpy as np

    from repro_torch.random import GeneratorDraws

    scen = [("resnet50", 0), ("transformer", 1)]
    pool, fronts = fleet_inputs(SMALL, "cpu")
    for label, inc in (("exact", False), ("incremental", True)):
        runs = {d: run_fleet(SMALL, d, scen, pool, fronts,
                             draws=[GeneratorDraws(s, "cpu") for _, s in scen],
                             incremental=inc)
                for d in ("cuda", "cpu")}
        for i, (w, s) in enumerate(scen):
            a, b = runs["cuda"].results[i], runs["cpu"].results[i]
            compare_rows(f"fleet small check (n_pool=64, T=6, {label}, "
                         f"{w}:s{s}): cuda rows", a, b)
            np.testing.assert_allclose(a.history[-1]["adrs"],
                                       b.history[-1]["adrs"], rtol=1e-5)


# --------------------------------------------------------------------------
# The mutable pool and the between-round proposer
def check_k4_pool_uses(dev, d: int, results: dict) -> None:
    """K4's two uses on a mutable pool against their plain versions on the
    card, timed as the rounds are: the refresh of dirty chunks
    (``K4_REFRESH_SHAPES``; the gathered chunks' V set to NaN first, so
    every row is recomputed) bitwise the same chunks of one full s0 = 0
    launch and within rtol = atol = 2e-5 of ``v_update_plain``; the scores
    (``K4_SCORES_SHAPES``) within rtol = atol = 2e-5 of the plain version's
    where finite, ``-inf`` at the same columns, the first-index argmax of
    the scores the launch's own pick, V bitwise unchanged."""
    import numpy as np
    import torch

    from repro_torch.kernels import round_fused as K4

    m, S = 3, MAIN["s_frontiers"]
    for nc, C, P, dirty in K4_REFRESH_SHAPES:
        t = k4_problem(dev, nc, C, d, P, m, S, seed=nc * C + len(dirty))
        full = {k: v.clone() for k, v in t.items()}
        V_full, _ = K4.round_select(*(full[k] for k in K4_ARGS), s0=0)
        didx = torch.as_tensor(dirty, device=dev)
        g = dict(t, V=torch.full_like(t["V"][didx], float("nan")),
                 pool_c=t["pool_c"][didx], evalm_c=t["evalm_c"][didx])
        K4.refresh_chunks(*(g[k] for k in K4_ARGS), nc_full=nc)
        V_plain = K4.v_update_plain(g["ls"], g["var"], g["L"],
                                    torch.zeros_like(g["V"]), g["x"],
                                    g["pool_c"], 0)
        torch.cuda.synchronize()
        bitwise = bool(torch.equal(g["V"], V_full[didx]))
        err = float((g["V"] - V_plain).abs().max())
        ok = bitwise and bool(torch.allclose(g["V"], V_plain, rtol=2e-5,
                                             atol=2e-5))
        print(f"  round_fused refresh of chunks {list(dirty)} of {nc} x {C} "
              f"(P={P}): bitwise the same chunks of one full s0 = 0 launch: "
              f"{bitwise}")
        k = len(dirty)
        args = [g[key] for key in K4_ARGS]
        _record(results, "round_fused_refresh", [k, C, d, m, P, S, 0], err,
                ok, time_ms(lambda: K4.refresh_chunks(*args, nc_full=nc)),
                time_ms(lambda: K4.v_update_plain(*args[:5], args[7], 0),
                        reps=2, repeats=3),
                None,
                bound_ms(k4_bytes(k, C, d, m, P, S, 0, use="refresh"),
                         k4_ops(k, C, d, m, P, S, 0, scoring=False)),
                chunks=list(dirty), of_chunks=nc, bitwise_full_launch=bitwise)
        del t, full, V_full, g, args
    for nc, C, P in K4_SCORES_SHAPES:
        t = k4_problem(dev, nc, C, d, P, m, S, seed=nc * C + P + 1)
        V0 = t["V"].clone()
        args = [t[key] for key in K4_ARGS]
        sk = torch.empty((nc, C), device=dev)
        sp = torch.empty((nc, C), device=dev)
        _, ik = K4.round_select(*args, s0=P, scores=sk)
        _, ip = K4.round_select_plain(*args, s0=P, scores=sp)
        torch.cuda.synchronize()
        a, b = sk.cpu().numpy(), sp.cpu().numpy()
        same_inf = bool(np.array_equal(np.isneginf(a), np.isneginf(b)))
        live = np.isfinite(b)
        err = float(np.abs(a[live] - b[live]).max())
        first = int(np.argmax(a.reshape(-1)))
        ok = (same_inf and bool(np.isfinite(a[live]).all())
              and bool(np.allclose(a[live], b[live], rtol=2e-5, atol=2e-5))
              and first == int(ik) and bool(torch.equal(t["V"], V0)))
        print(f"  round_fused scores at {nc} x {C} (P={P}): -inf at the same "
              f"{int((~live).sum())} columns: {same_inf}; first-index argmax "
              f"of the scores {first}, the launch's pick {int(ik)}, the "
              f"plain pick {int(ip)}")
        large = nc * C >= K4_LARGE
        _record(results, "round_fused_scores", [nc, C, d, m, P, S, P], err,
                ok, time_ms(lambda: K4.round_select(*args, s0=P, scores=sk),
                            reps=5 if large else 20,
                            repeats=5 if large else 7),
                time_ms(lambda: K4.round_select_plain(*args, s0=P, scores=sp),
                        reps=1 if large else 2, repeats=1 if large else 3),
                None, bound_ms(k4_bytes(nc, C, d, m, P, S, P, use="scores"),
                               k4_ops(nc, C, d, m, P, S, P)),
                argmax_equal=first == int(ik))
        del t, args, sk, sp
        torch.cuda.empty_cache()


def _same_trajectory(what: str, a, b) -> None:
    """Two results' rows, metrics and history (without wall times) equal
    bit for bit, and their live pools where they have one."""
    import numpy as np

    compare_rows(what, a, b)
    strip = [[{k: v for k, v in h.items() if k != "wall_s"} for h in r.history]
             for r in (a, b)]
    if not (np.array_equal(a.y, b.y) and strip[0] == strip[1]):
        raise AssertionError(f"{what}: metrics or history differ")
    if (a.pool_live is None) != (b.pool_live is None) or (
            a.pool_live is not None
            and not np.array_equal(a.pool_live, b.pool_live)):
        raise AssertionError(f"{what}: the live pools differ")


def _check_proposal_launches(what: str, per_round: list, S: int) -> int:
    """Each round of a proposer run launched K4 S times for the round, S
    times for the scores and 0 or S times for a refresh (one chunk: the
    main path's pool is one); returns the steps that refreshed."""
    for i, c in enumerate(per_round):
        if (c["refactor"] + c["block_update"] != S or c["scores"] != S
                or c["refresh"] not in (0, S) or c["score_only"]):
            raise AssertionError(f"{what}: round {i + 1} launched round_fused"
                                 f" by class {c}")
    return sum(c["refresh"] > 0 for c in per_round)


def proposal_step_seconds(res, dev, cfg: dict) -> dict:
    """One proposal step (``propose_and_replace``) at a proposer run's final
    state, part by part, each ending in a synchronize: the engine's
    ``pool_scores`` (one K4 launch) and ``pool_replace`` (the chunk
    refresh), timed by wrapping them on the engine, and the host's
    candidate search and victim ranking (the rest of the step)."""
    import torch

    from repro_torch.core import BOEngine, make_space
    from repro_torch.core.propose import ProposerConfig, propose_and_replace
    from repro_torch.core.tuner import _encode_cols
    from repro_torch.random import GeneratorDraws

    space, live = make_space(), res.pool_live
    rows, y = res.evaluated_rows, res.y
    eng = BOEngine(_pool_icd(res, live, dev), incremental=True,
                   gp_steps=cfg["gp_steps"], s_frontiers=cfg["s_frontiers"],
                   device=dev)
    eng.observe(rows, y)
    draws = GeneratorDraws(5, dev)
    sub, eps = draws.round(len(live), cfg["frontier_subset"], 3,
                           cfg["s_frontiers"])
    eng.select(eps, sub)
    secs = {}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            secs[key] = time.perf_counter() - t
            return out
        return run

    eng.pool_scores = timed("pool_scores_s", eng.pool_scores)
    eng.pool_replace = timed("pool_replace_s", eng.pool_replace)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = propose_and_replace(
        eng, space, functools.partial(draws.propose, 0), live,
        cfg=ProposerConfig(**PROPOSER),
        encode_cols=_encode_cols(space, res.space, res.v, dev),
        evaluated=[rows], ys=[y])
    torch.cuda.synchronize()
    step = time.perf_counter() - t0
    if out is None:
        raise AssertionError("the timed proposal step replaced nothing")
    out = dict(secs, search_s=step - secs["pool_scores_s"]
               - secs["pool_replace_s"], step_s=step,
               replaced=int(len(out.victims)))
    print(f"  one proposal step: pool_scores {out['pool_scores_s']:.4f} s, "
          f"candidate search {out['search_s']:.4f} s, pool_replace "
          f"{out['pool_replace_s']:.4f} s ({out['replaced']} columns), in all "
          f"{out['step_s']:.4f} s")
    return out


def proposer_phase(dev, res_i, launches_i: dict, card: str) -> dict:
    """The paper-protocol soc_tuner with the proposer on (every count set to
    0 just before it): final ADRS beside the proposer-less run's, replaced
    columns, chunk refreshes, K4 by class (the rounds, one ``scores`` a
    step, one ``refresh`` a step that replaced something), K3 (one more a
    step), s/round with and without it, one proposal step's seconds; then
    the proposer off (the main incremental run, bit for bit) and a run cut
    at ``RESUME_CUT`` and resumed (the uninterrupted run, bit for bit)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import pareto_count as K3
    from repro_torch.kernels import round_fused as K4
    from repro_torch.random import GeneratorDraws

    T = MAIN["T"]
    probe = RoundProbe(GeneratorDraws(MAIN["seed"], dev))
    print("proposer: soc_tuner", json.dumps(
        {**MAIN, "incremental": True, "proposer": PROPOSER}))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res_p, pool, ref, flow = run_tuner(MAIN, dev, draws=probe,
                                       incremental=True, proposer=PROPOSER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__.rsplit(".", 1)[1]: k.launches
                for k in kernels.KERNELS}
    by_class = dict(K4.class_launches)
    k3_class = dict(K3.shape_launches)
    per_round = probe.class_per_round()
    check_result(res_p, res_p.pool_live, ref, MAIN)
    st, ps = res_p.engine_stats, res_p.engine_stats["proposer"]
    refreshed = _check_proposal_launches("proposer", per_round, 1)
    s_round = [np.mean([h["wall_s"] for h in r.history[1:]])
               for r in (res_p, res_i)]
    a_p, a_i = res_p.history[-1]["adrs"], res_i.history[-1]["adrs"]
    print(f"  proposer [{card}]: {wall:.1f} s, final ADRS {a_p:.5f} (without "
          f"the proposer {a_i:.5f}), {s_round[0]:.4f} s a round against "
          f"{s_round[1]:.4f} s without it")
    print(f"  proposer: {ps['rounds']} proposal steps, {ps['proposed']} "
          f"candidates, replaced {ps['replaced']}, pool_replacements "
          f"{st['pool_replacements']}, v_chunk_refreshes "
          f"{st['v_chunk_refreshes']}; launches {launches}; round_fused by "
          f"class {by_class} ({refreshed} steps refreshed a chunk); "
          f"pareto_count {launches['pareto_count']} (without the proposer "
          f"{launches_i['pareto_count']}; by class {k3_class})")
    if (by_class["refactor"] + by_class["block_update"] != T
            or by_class["scores"] != T or by_class["refresh"] != refreshed
            or st["v_chunk_refreshes"] != refreshed or refreshed < 1):
        raise AssertionError(f"proposer: round_fused by class {by_class}, "
                             f"{st['v_chunk_refreshes']} chunk refreshes")
    if ps["replaced"] != st["pool_replacements"] or ps["replaced"] < 1:
        raise AssertionError(f"proposer: replaced {ps['replaced']}, "
                             f"pool_replacements {st['pool_replacements']}")
    if launches["pareto_count"] != launches_i["pareto_count"] + T:
        raise AssertionError(
            f"proposer: pareto_count launched {launches['pareto_count']} "
            f"times, not {launches_i['pareto_count']} + {T}")
    step = proposal_step_seconds(res_p, dev, MAIN)

    off = run_tuner(MAIN, dev, incremental=True,
                    proposer={"enabled": False})[0]
    _same_trajectory("proposer off, incremental rows", off, res_i)
    print(f"  proposer off: final ADRS {off.history[-1]['adrs']!r}, the main "
          f"incremental run's {a_i!r}: rows, metrics and history bit for bit")

    with tempfile.TemporaryDirectory() as d:
        run_tuner({**MAIN, "T": RESUME_CUT}, dev, incremental=True,
                  proposer=PROPOSER, checkpoint_dir=d)
        resumed = run_tuner(MAIN, dev, incremental=True, proposer=PROPOSER,
                            checkpoint_dir=d, resume=True)[0]
    _same_trajectory(f"proposer, cut at round {RESUME_CUT} and resumed", resumed,
                     res_p)
    print(f"  resume: cut at round {RESUME_CUT}, resumed to {T}: rows, metrics, "
          f"ADRS history and live pool equal the uninterrupted run's bit for "
          f"bit (final ADRS {resumed.history[-1]['adrs']!r})")
    return dict(wall_s=wall, final_adrs=a_p, final_adrs_without=a_i,
                s_per_round=s_round[0], s_per_round_without=s_round[1],
                proposer_stats=ps, engine_stats=st, launches=launches,
                round_fused_by_class=by_class, round_fused_per_round=per_round,
                pareto_count_without=launches_i["pareto_count"],
                steps_refreshed=refreshed, proposal_step=step,
                history=res_p.history)


def fleet_proposer_phase(dev, fleet: dict, card: str) -> dict:
    """The six-scenario incremental fleet with the proposer on (counts set
    to 0 just before it): each scenario's final ADRS beside the
    proposer-less fleet's, K4 by class a round (6 ``scores`` a step, 6
    ``refresh`` a step that replaced something), replaced columns and the
    cache's invalidations; then the run cut at ``RESUME_CUT`` and resumed,
    bit for bit the uninterrupted one."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import round_fused as K4
    from repro_torch.random import GeneratorDraws

    scen = [(w, s) for w in FLEET_WORKLOADS for s in FLEET_SEEDS]
    S = len(scen)
    pool, fronts = fleet_inputs(MAIN, dev)
    probe = RoundProbe(GeneratorDraws(scen[0][1], dev))
    draws = [probe] + [GeneratorDraws(s, dev) for _, s in scen[1:]]
    print(f"fleet (proposer): fleet_tuner, {S} scenarios", json.dumps(
        {**MAIN, "workload": list(FLEET_WORKLOADS), "seeds": list(FLEET_SEEDS),
         "incremental": True, "proposer": PROPOSER}))
    kernels.reset_launches()
    t0 = time.perf_counter()
    fr = run_fleet(MAIN, dev, scen, pool, fronts, draws=draws,
                   incremental=True, proposer=PROPOSER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_class = dict(K4.class_launches)
    per_round = probe.class_per_round()
    refreshed = _check_proposal_launches("fleet (proposer)", per_round, S)
    without = fleet["incremental"]["final_adrs"]
    for sc, res in zip(fr.scenarios, fr.results):
        check_result(res, res.pool_live, fronts[sc.workload],
                     {**MAIN, "workload": sc.workload})
        print(f"  {sc.label}: final ADRS {res.history[-1]['adrs']:.5f} "
              f"(without the proposer {without[sc.label]:.5f})")
    ps, st = fr.results[0].engine_stats["proposer"], fr.results[0].engine_stats
    round_s = np.mean([h["wall_s"] for h in fr.results[0].history[1:]])
    print(f"  fleet (proposer) [{card}]: {wall:.1f} s, {round_s:.4f} s a fleet "
          f"round (without the proposer "
          f"{np.mean(fleet['incremental']['round_wall_s']):.4f}); replaced "
          f"{ps['replaced']} (pool_replacements {st['pool_replacements']}), "
          f"cache invalidated {fr.cache.invalidated}, {fr.cache.summary()}")
    print(f"  fleet (proposer): round_fused by class {by_class}; scores "
          f"launches a step {[c['scores'] for c in per_round]}; refresh "
          f"launches a step {[c['refresh'] for c in per_round]}")
    if (by_class["scores"] != S * MAIN["T"] or ps["replaced"] < 1
            or ps["replaced"] != st["pool_replacements"]):
        raise AssertionError(f"fleet (proposer): round_fused by class "
                             f"{by_class}, replaced {ps['replaced']}")
    with tempfile.TemporaryDirectory() as d:
        run_fleet({**MAIN, "T": RESUME_CUT}, dev, scen, pool, fronts,
                  incremental=True, proposer=PROPOSER, checkpoint_dir=d)
        resumed = run_fleet(MAIN, dev, scen, pool, fronts, incremental=True,
                            proposer=PROPOSER, checkpoint_dir=d, resume=True)
    for sc, a, b in zip(fr.scenarios, resumed.results, fr.results):
        _same_trajectory(f"fleet (proposer) {sc.label}, cut at round "
                         f"{RESUME_CUT} and resumed", a, b)
    print(f"  fleet resume: cut at round {RESUME_CUT}, resumed to {MAIN['T']}: "
          f"every scenario's rows, metrics, ADRS history and the live pool "
          f"equal the uninterrupted run's bit for bit")
    return dict(wall_s=wall, round_s=round_s, final_adrs=fr.final_adrs(),
                round_fused_by_class=by_class, round_fused_per_round=per_round,
                steps_refreshed=refreshed, proposer_stats=ps,
                pool_replacements=st["pool_replacements"],
                v_chunk_refreshes=st["v_chunk_refreshes"],
                cache_invalidated=fr.cache.invalidated)


def _stepped_live_pools(run, pool, T: int) -> tuple:
    """``run(t, checkpoint_dir)`` for t = 1..T in one temporary directory,
    each call resuming the last one's snapshot and adding a round (a
    resumed run is bit for bit the uninterrupted one): returns the last
    results and each step's live pool and victims (the rows whose design
    changed)."""
    import tempfile

    import numpy as np

    lives, victims, prev = [], [], np.asarray(pool)
    with tempfile.TemporaryDirectory() as d:
        for t in range(1, T + 1):
            results = run(t, d)
            live = results[0].pool_live
            lives.append(live)
            victims.append(np.flatnonzero((live != prev).any(axis=1)).tolist())
            prev = live
    return results, lives, victims


def proposer_card_vs_cpu() -> None:
    """At n_pool=64 (``SMALL``), draws made on the CPU and handed to both
    runs, incremental with the proposer on, one round a call (each resuming
    the last): the card's picks, each step's victims and live pool, and the
    final live pool equal the CPU's (plain K4), for soc_tuner and for the
    fleet (resnet50/0, transformer/1)."""
    import numpy as np

    from repro_torch.random import GeneratorDraws

    scen = [("resnet50", 0), ("transformer", 1)]
    pool, fronts = fleet_inputs(SMALL, "cpu")
    for driver in ("soc_tuner", "fleet_tuner"):
        runs, lives, victims = {}, {}, {}
        for dev in ("cuda", "cpu"):
            def run(t, ckpt, dev=dev):
                kw = dict(incremental=True, proposer=PROPOSER,
                          checkpoint_dir=ckpt, resume=True)
                if driver == "soc_tuner":
                    return [run_tuner({**SMALL, "T": t}, dev,
                                      GeneratorDraws(SMALL["seed"], "cpu"),
                                      pool_device="cpu", **kw)[0]]
                return run_fleet({**SMALL, "T": t}, dev, scen, pool, fronts,
                                 draws=[GeneratorDraws(s, "cpu")
                                        for _, s in scen], **kw).results
            runs[dev], lives[dev], victims[dev] = _stepped_live_pools(
                run, pool, SMALL["T"])
        for a, b in zip(runs["cuda"], runs["cpu"]):
            compare_rows(f"proposer small check (n_pool=64, {driver}): cuda "
                         f"rows", a, b)
            np.testing.assert_allclose(a.history[-1]["adrs"],
                                       b.history[-1]["adrs"], rtol=1e-5)
        print(f"  victims a step (cuda): {victims['cuda']}")
        if victims["cuda"] != victims["cpu"] or not any(victims["cuda"]):
            raise AssertionError(f"{driver}: victims differ: cpu "
                                 f"{victims['cpu']}")
        if not all(np.array_equal(a, b)
                   for a, b in zip(lives["cuda"], lives["cpu"])):
            raise AssertionError(f"{driver}: the live pools differ")
        print(f"  {driver}: the card's victims and live pool after every "
              f"step equal the CPU's")


#: K5 shapes (B, S, H, KV heads, q·k head dim, v head dim, window): the
#: serve phase's prefill, the S at which the reference's ``_sdpa`` chunks
#: its keys, a ragged S, the MLA serve phase's prefill (minicpm3-4b's
#: un-absorbed attention: 96 = 64 nope + 32 rope dims, v 64, 40 heads),
#: deepseek-v2-lite's (192 = 128 nope + 64 rope, v 128, 16 heads) and
#: recurrentgemma-9b's (256, 16 heads on 1 KV head) at its window of 2048,
#: without a window, and at a ragged S with a window of 100.
K5_SHAPES = [(4, 2048, 32, 8, 128, 128, None),
             (1, 4096, 32, 8, 128, 128, None),
             (2, 2000, 32, 8, 128, 128, None),
             (4, 2048, 40, 40, 96, 64, None),
             (4, 2048, 16, 16, 192, 128, None),
             (4, 4096, 16, 1, 256, 256, 2048),
             (4, 4096, 16, 1, 256, 256, None),
             (2, 1000, 16, 1, 256, 256, 100),
             (4, 416, 6, 6, 64, 64, None)]
#: the kernel-line names of K5's other head dims (64, 64: whisper-tiny's
#: causal decoder prefill, the last shape above)
K5_NAMES = {(96, 64): "flash_attn_mla", (192, 128): "flash_attn_mla_192",
            (256, 256): "flash_attn_window",
            (64, 64): "flash_attn_whisper_dec"}
#: K5 without the causal mask (B, S, H, KV heads, head dim), on both
#: routes: whisper-tiny's encoder (S 1500 = 23 x 64 + 28: the last key
#: tile holds 36 keys past S that TMA fills with zeros and the kernel must
#: mask), ragged S 65 (one real key in the last tile) and 100, and a tile
#: multiple (1536). At S 65 and 100 the kernel-level planted fault "keys
#: past S take softmax mass" (the reference's Pallas wrapper pads S to 128
#: with zero keys and masks nothing without causal) must be rejected; at
#: 1500 it moves outputs by only ~0.004, which the serve phase could not
#: see, so it is printed there.
K5_NONCAUSAL_SHAPES = [(4, 1500, 6, 6, 64), (2, 65, 6, 6, 64),
                       (2, 100, 6, 6, 64), (4, 1536, 6, 6, 64)]
#: bf16 outputs rounded from float32 results summed in another order may
#: flip by one bf16 ulp (<= 2^-7 relative); atol for outputs near 0.
K5_RTOL, K5_ATOL = 2.0 ** -7, 1e-3
#: the serve phases: mistral-nemo-12b (GQA) and minicpm3-4b (MLA) at full
#: width, Engine.generate
#: (16 greedy tokens: 32 before the query-shard checks were added)
SERVE = dict(arch="mistral-nemo-12b", batch=4, prompt=2048, gen=16,
             max_len=2080, seed=0)
SERVE_MLA = dict(SERVE, arch="minicpm3-4b")
#: the MoE serve phases: deepseek-v2-lite-16b (MLA, 64 routed experts,
#: top-6, 2 shared; 15.7 B parameters) at its published width and depth,
#: and phi3.5-moe-42b-a6.6b (GQA, 16 experts, top-2) at its published width
#: with 24 of its 32 layers: all 32 are 41.9 B parameters, 83.7 GB in bf16,
#: more than the 80 GB card; 24 are 31.5 B, ~63 GB
SERVE_MOE_MLA = dict(SERVE, arch="deepseek-v2-lite-16b")
SERVE_MOE = dict(SERVE, arch="phi3.5-moe-42b-a6.6b", n_layers=24)
#: the SSM and hybrid serve phases at their published widths and depths:
#: mamba2-370m (48 Mamba-2 layers, 0.37 B parameters) at a 2048-token
#: prompt, and recurrentgemma-9b (12 groups of rglru, rglru, windowed
#: attention and a tail of 2 rglru; 9.57 B parameters) at a 4096-token
#: prompt, past its 2048 window: the window cuts K5's mask, the cache goes
#: to the ring through ``_ring_place``, and decode wraps the ring (its
#: 4128-slot ``max_len`` leaves a ring of 2048)
SERVE_SSM = dict(SERVE, arch="mamba2-370m")
SERVE_HYBRID = dict(SERVE, arch="recurrentgemma-9b", prompt=4096,
                    max_len=4128)
#: the encoder-decoder and vision serve phases at their published widths
#: and depths: whisper-tiny (4 encoder layers over frames [4, 1500, 384],
#: 4 decoder layers with cross-attention) at a 416-token prompt and 32
#: tokens, max_len 448 (whisper's own decoder context); pixtral-12b
#: (mistral-nemo's backbone, 40 layers) at a 2048-token prompt whose first
#: 1024 slots are patch embeddings. The frames and patch embeddings are
#: random normal draws from the phase's generator, standing for the conv
#: frontend's and the ViT's outputs (the reference's stubs)
SERVE_AUDIO = dict(SERVE, arch="whisper-tiny", prompt=416, max_len=448)
SERVE_VLM = dict(SERVE, arch="pixtral-12b")
#: the SSM phase's chunked prefill against its recurrent form: the first
#: 96 tokens of one prompt (one chunk of 256, padded) prefilled, and 96
#: decode steps from a zeroed cache. With random weights the 48 layers
#: carry bf16 rounding noise up the stack (on the CPU at full width, the
#: two forms' last-position logits differ by max 0.045 / mean 0.0078 at 4
#: layers, 0.18 / 0.030 at 12 and 0.36 / 0.064 at 24), so the end-to-end
#: difference is printed and the check is made layer by layer: each block
#: on the prefill's input to it, prefilled and stepped 96 times, its output
#: through the final norm and the head at every position within the serve
#: tolerances, and its final state within ``SSD_STATE_RTOL`` of the
#: largest |state| (the CPU, 24 layers: at most 2.3e-4; conv windows
#: 3.5e-5).
SSD_CHECK_TOKENS = 96
SSD_STATE_RTOL = 2e-3
#: the MoE layer checked card against CPU: deepseek-v2-lite-16b's at full
#: width, a float32 hidden input of B 1, S 2048 (T 2048, capacity 240).
#: The hidden states share a direction, as a residual stream's do, so the
#: router favours some experts and they overflow (i.i.d. unit inputs
#: spread the tokens evenly: busiest 227 of 240 on the card). Tolerance:
#: the two devices' float32 sums over d 2048 and ff 1408 in other orders
#: differ by ~1e-6 of the outputs (float32 against float64 on the CPU:
#: 7.6e-7), which are ~100 (fan-in init over E = 64): max |diff| <=
#: MOE_F32_RTOL · max |y|.
MOE_CHECK = dict(arch="deepseek-v2-lite-16b", batch=1, seq=2048, seed=7)
MOE_F32_RTOL = 1e-5
#: kernel run vs K5's plain version, bf16 end to end through 40 layers:
#: attention outputs differ by bf16 ulp flips, which the residual stream
#: carries. Logits are O(1) (|max| ~4, one ulp 2^-6 there): max |diff| <=
#: 0.125 (eight ulps) and mean |diff| <= 0.02. The same comparison (the
#: CPU's _sdpa vs K5's plain version) at 40 layers and d_model 640 on the
#: CPU gave max 0.031 and mean 0.0055. The serve phase plants two faults
#: (``planted_faults``) and fails unless these tolerances reject both.
SERVE_ATOL, SERVE_MEAN_TOL = 0.125, 0.02


#: the service phase (ROADMAP queue 1 item 12), at the paper protocol of
#: ``MAIN``: the mock flow latency of the q = 4 async runs (``DelayedFlow``,
#: one sleep a call) and their concurrency; the fleet service's scenarios,
#: budget a scenario and shared workers (``benchmarks/service_bench.py
#: --fleet``'s defaults: resnet50 and transformer at seed 0, T 24, 4
#: workers, so q = 2 a scenario); the server's mix
#: (``tools/regen_golden.py``'s ``server_two_jobs``) at T 20 a job; and the
#: evaluation after which the CLI run is SIGKILLed.
SERVICE_DELAY_S = 0.5  # 1.0 before the query-shard checks were added
SERVICE_Q = 4
SERVICE_FLEET = dict(scenarios=(("resnet50", 0), ("transformer", 0)), T=24,
                     workers=4)
SERVER_JOBS = (dict(workload="resnet50", seed=0, q=2, min_done=1),
               dict(workload="transformer", seed=1, q=1))
CLI_KILL_AFTER = 8
#: where the CLI runs keep their checkpoints, flow cache and event log
#: (under the git-ignored build directory)
SERVICE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_service"


def _protocol() -> dict:
    """``MAIN``'s knobs that every service entry point takes."""
    return {k: MAIN[k] for k in ("n", "b", "gp_steps", "s_frontiers",
                                 "frontier_subset")}


def _main_inputs(dev):
    """The main path's space, pool and reference front, as ``run_tuner``
    builds them (the same launches)."""
    import torch

    from repro_torch.core import make_space, pareto_front
    from repro_torch.soc import VLSIFlow

    space = make_space()
    gen = torch.Generator(device=dev).manual_seed(MAIN["seed"])
    pool = space.sample(gen, MAIN["n_pool"]).cpu().numpy()
    ref = pareto_front(VLSIFlow(space, MAIN["workload"], device=dev)(pool),
                       device=dev)
    return space, pool, ref


def _k4_split(stats: dict, launches: dict, what: str) -> dict:
    """K4's launches of a service run: one a refill (its round) and one a
    fantasy step; fails unless they add up."""
    rounds, fant = stats["rounds"], stats["fantasy_steps"]
    if launches["round_fused"] != rounds + fant:
        raise AssertionError(f"{what}: round_fused launched "
                             f"{launches['round_fused']} times, the engine "
                             f"counts {rounds} rounds + {fant} fantasy steps")
    return dict(rounds=rounds, fantasy_steps=fant)


def _k1_check(what: str, launches: dict, want: int) -> None:
    if launches["systolic_eval"] != want:
        raise AssertionError(f"{what}: systolic_eval launched "
                             f"{launches['systolic_eval']} times here, "
                             f"expected {want}")


def service_async(dev, space, pool, ref, r_q1, card: str) -> dict:
    """q = 1 inline and q = 4 over threads and spawn processes, all over
    ``DelayedFlow(VLSIFlow(cuda), SERVICE_DELAY_S)``; the q = 1 run is
    ``r_q1`` (the same run without the delay) bit for bit."""
    import torch

    from repro_torch import kernels
    from repro_torch.service import service_tuner
    from repro_torch.soc import DelayedFlow, VLSIFlow

    out, res = {}, {}
    for label, q, ex in (("q=1 inline", 1, "inline"),
                         (f"q={SERVICE_Q} thread", SERVICE_Q, "thread"),
                         (f"q={SERVICE_Q} process", SERVICE_Q, "process")):
        flow = DelayedFlow(VLSIFlow(space, MAIN["workload"], device=dev),
                           SERVICE_DELAY_S)
        kernels.reset_launches()
        t0 = time.perf_counter()
        r = service_tuner(space, pool, flow, workload=MAIN["workload"],
                          T=MAIN["T"], q=q, min_done=1, ordered=True,
                          executor=ex, max_workers=q, reference_front=ref,
                          seed=MAIN["seed"], device=dev, **_protocol())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by = launch_counts()
        st, svc = r.engine_stats, r.engine_stats["service"]
        k4 = _k4_split(st, launches, label)
        # K1 in this process: the prologue's two flow calls (ICD trials,
        # TED init) and, unless the workers are processes, one a dispatch
        _k1_check(label, launches,
                  2 + (0 if ex == "process" else svc["pool_dispatched"]))
        res[label] = r
        out[label] = dict(wall_s=wall, adrs=r.history[-1]["adrs"],
                          dispatched=svc["pool_dispatched"],
                          launches=launches, by_class=by, k4=k4)
        print(f"  {label}, DelayedFlow {SERVICE_DELAY_S} s a call: "
              f"{wall:.2f} s, final ADRS {r.history[-1]['adrs']:.5f}, "
              f"{svc['pool_dispatched']} dispatches; K4 "
              f"{launches['round_fused']} = {k4['rounds']} refills + "
              f"{k4['fantasy_steps']} fantasy steps, by class "
              f"{by['round_fused']}; K1 here {launches['systolic_eval']}"
              + (" (the workers' launches stay in the workers)"
                 if ex == "process" else ""))
    q1, qt, qp = res.values()
    _same_trajectory(f"  q={SERVICE_Q} process vs thread: rows", qp, qt)
    _same_trajectory("  q=1 under the delay vs without: rows", q1, r_q1)
    walls = [v["wall_s"] for v in out.values()]
    out["speedup_thread"] = walls[0] / walls[1]
    out["speedup_process"] = walls[0] / walls[2]
    print(f"  q={SERVICE_Q} against q=1 under the same delay: "
          f"{out['speedup_thread']:.2f}x (threads), "
          f"{out['speedup_process']:.2f}x (processes) [{card}]")
    return out


def service_fleet(dev, space, pool) -> dict:
    """``fleet_service`` over one 4-worker thread pool, then at q = 1 inline
    against ``fleet_tuner(incremental=True)``."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import FleetScenario, fleet_tuner, pareto_front
    from repro_torch.service import fleet_service
    from repro_torch.soc import VLSIFlow

    scen = [FleetScenario(w, seed=s) for w, s in SERVICE_FLEET["scenarios"]]
    fronts = {sc.workload: pareto_front(
        VLSIFlow(space, sc.workload, device=dev)(pool), device=dev)
        for sc in scen}
    T, workers = SERVICE_FLEET["T"], SERVICE_FLEET["workers"]
    kw = dict(T=T, reference_fronts=fronts, device=dev, **_protocol())
    kernels.reset_launches()
    t0 = time.perf_counter()
    fs = fleet_service(space, pool, scen, q=workers // len(scen), min_done=1,
                       executor="thread", max_workers=workers, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by = launch_counts()
    st = fs.results[0].engine_stats
    k4 = dict(launches=launches["round_fused"], rounds=st["rounds"],
              fantasy_steps=st["fantasy_steps"], by_class=by["round_fused"])
    svc = st["service"]
    adrs = {sc.label: r.history[-1]["adrs"]
            for sc, r in zip(fs.scenarios, fs.results)}
    for sc, r in zip(fs.scenarios, fs.results):
        if len(r.evaluated_rows) != len(set(r.evaluated_rows.tolist())) or \
                len(r.history) != T + 1 or not np.isfinite(r.y).all():
            raise AssertionError(f"fleet service {sc.label}: a bad result")
    print(f"  fleet_service, {len(scen)} scenarios x T {T}, q "
          f"{workers // len(scen)} each over {workers} threads: {wall:.2f} s,"
          f" final ADRS {adrs}; {svc['pool_dispatched']} dispatches, "
          f"{svc['pool_inflight_hits']} in-flight hits, memo hits "
          f"{svc['fleet_cache']['memo_hits']}, prologue cache hits "
          f"{svc['fleet_cache']['hits']} of "
          f"{svc['fleet_cache']['hits'] + svc['fleet_cache']['misses']}; "
          f"K4 {k4['launches']} ({k4['rounds']} rounds x {len(scen)} "
          f"scenarios + fantasy steps), K1 {launches['systolic_eval']}")
    f1 = fleet_service(space, pool, scen, q=1, executor="inline", **kw)
    ft = fleet_tuner(space, pool, scen, incremental=True, **kw)
    y_bitwise = True
    for sc, a, b in zip(scen, f1.results, ft.results):
        compare_rows(f"  fleet_service q=1 inline vs fleet_tuner, "
                     f"{sc.label}", a, b)
        y_bitwise = y_bitwise and np.array_equal(a.y, b.y)
    print(f"  fleet_service q=1 = fleet_tuner: rows equal; metrics "
          f"{'bitwise equal' if y_bitwise else 'not bitwise equal'}")
    return dict(wall_s=wall, adrs=adrs, service=svc, launches=launches,
                k4=k4, q1_metrics_bitwise=y_bitwise)


def service_server(dev, space, pool) -> dict:
    """``TunerServer`` served on localhost: the mix submitted, its status
    and metrics read through ``request`` mid-run, shut down at the end;
    each job against the job alone through ``fleet_service``."""
    import threading

    import numpy as np

    from repro_torch.core import adrs, pareto_front
    from repro_torch.obs import MetricsRegistry
    from repro_torch.service import (JobSpec, TunerServer, fleet_service,
                                     request, serve)
    from repro_torch.soc import VLSIFlow

    specs = [dict(job, T=MAIN["T"], **_protocol()) for job in SERVER_JOBS]
    reg = MetricsRegistry()
    srv = TunerServer(space, pool, executor="thread", max_workers=4,
                      metrics=reg, device=dev)
    got, ready = {}, threading.Event()
    th = threading.Thread(target=serve, args=(srv,), daemon=True, kwargs=dict(
        ready_cb=lambda p: (got.update(port=p), ready.set())))
    t0 = time.perf_counter()
    th.start()
    try:
        if not ready.wait(60):
            raise AssertionError("the server never listened")
        port = got["port"]
        jids = [request(port, {"verb": "submit", "spec": sp})["job"]
                for sp in specs]
        scraped, deadline = None, time.time() + 600
        while time.time() < deadline:
            st = request(port, {"verb": "status"})["status"]
            jobs = st["jobs"]
            if scraped is None and any(j["status"] == "RUNNING"
                                       and j["done"] >= 1
                                       for j in jobs.values()):
                scraped = request(port, {"verb": "metrics"})["metrics"]
            if all(jobs[j]["status"] in ("DONE", "FAILED") for j in jids):
                break
            time.sleep(0.05)
        if scraped is None:
            raise AssertionError("no metrics scrape while a job ran")
        mid_bytes = scraped["gauges"]["engine_device_bytes"]["series"][""]
        if not mid_bytes > 0:
            raise AssertionError(f"engine_device_bytes {mid_bytes} mid-run")
        if not request(port, {"verb": "shutdown"})["ok"]:
            raise AssertionError("shutdown refused")
        th.join(120)
        if th.is_alive():
            raise AssertionError("the serve loop did not stop")
    finally:
        srv.close()
    wall = time.perf_counter() - t0
    hist = reg.snapshot()["histograms"]["scheduler_cycle_seconds"][
        "series"][""]
    cycle_s = hist["sum"] / hist["count"]
    out = dict(wall_s=wall, cycles=hist["count"], cycle_s=cycle_s,
               engine_device_bytes_mid_run=mid_bytes, jobs={})
    for jid, sp in zip(jids, specs):
        job = srv.job(jid)
        if job.status != "DONE":
            raise AssertionError(f"job {jid}: {job.status} {job.error}")
        spec = JobSpec(**sp)
        knobs = {k: v for k, v in sp.items() if k not in ("workload", "seed")}
        want = fleet_service(space, pool, [spec.scenario], executor="inline",
                             device=dev, **knobs).results[0]
        _same_trajectory(f"  server job {job.label} vs the job alone",
                         job.result(), want)
        front = pareto_front(VLSIFlow(space, spec.workload, device=dev)(pool),
                             device=dev)
        a = adrs(front, job.result().pareto_y)
        out["jobs"][job.label] = dict(adrs=a, stats={
            k: job.result().engine_stats[k]
            for k in ("rounds", "fantasy_steps", "refactors")})
        print(f"  server job {job.label}: final ADRS {a:.5f}, "
              f"{out['jobs'][job.label]['stats']}")
    print(f"  server: {wall:.2f} s, {hist['count']} scheduler cycles, "
          f"{cycle_s:.4f} s a cycle; engine_device_bytes mid-run "
          f"{mid_bytes:.0f}")
    assert np.isfinite(cycle_s)
    return out


def service_cli(dev, space, pool) -> dict:
    """The port's CLI in subprocesses: SIGKILLed after an early checkpoint,
    resumed, and an uninterrupted run; then a re-run on the filled cache
    (here) and the event log through ``build_chrome_trace``."""
    import signal

    import numpy as np

    from repro_torch.obs import build_chrome_trace, read_events
    from repro_torch.service import service_tuner
    from repro_torch.soc import VLSIFlow

    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    SERVICE_DIR.mkdir(parents=True)
    ck, cache, ev = (str(SERVICE_DIR / p) for p in ("ckpt", "cache",
                                                    "events.jsonl"))
    base = [sys.executable, "-m", "repro_torch.service.cli", "--n-pool",
            str(MAIN["n_pool"]), "--T", str(MAIN["T"]), "--q", "2",
            "--executor", "thread", "--device", str(dev), "--quiet"]
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))

    def cli(*args, check=True):
        t0 = time.perf_counter()
        p = subprocess.run(base + list(args), env=env, capture_output=True,
                           text=True, timeout=600)
        if check and p.returncode != 0:
            raise AssertionError(f"CLI {args} failed: {p.stderr[-2000:]}")
        return p, time.perf_counter() - t0

    dead, t_dead = cli("--checkpoint-dir", ck, "--cache-dir", cache,
                       "--events", ev, "--kill-after", str(CLI_KILL_AFTER),
                       "--out", str(SERVICE_DIR / "dead.json"), check=False)
    if dead.returncode != -signal.SIGKILL:
        raise AssertionError(f"the CLI was not SIGKILLed: {dead.returncode}"
                             f" {dead.stderr[-2000:]}")
    _, t_res = cli("--checkpoint-dir", ck, "--cache-dir", cache, "--events",
                   ev, "--resume", "--out", str(SERVICE_DIR / "resumed.json"))
    _, t_full = cli("--out", str(SERVICE_DIR / "full.json"))
    resumed, full = (json.loads((SERVICE_DIR / f).read_text())
                     for f in ("resumed.json", "full.json"))
    strip = [[{k: v for k, v in h.items() if k != "wall_s"}
              for h in r["history"]] for r in (resumed, full)]
    if resumed["evaluated_rows"] != full["evaluated_rows"] or \
            resumed["y"] != full["y"] or strip[0] != strip[1]:
        raise AssertionError("the SIGKILLed and resumed CLI run is not the "
                             "uninterrupted one")
    rerun = service_tuner(space, pool, VLSIFlow(space, MAIN["workload"],
                                                device=dev),
                          T=MAIN["T"], q=2, executor="thread",
                          cache_dir=cache, seed=0, device=dev)
    svc = rerun.engine_stats["service"]
    if svc["pool_dispatched"] or svc["disk"]["misses"] or \
            rerun.evaluated_rows.tolist() != full["evaluated_rows"]:
        raise AssertionError(f"cache re-run: {svc}")
    recs = read_events(ev)
    trace = build_chrome_trace(recs)
    gens = sorted({r["gen"] for r in recs})
    if gens != [0, 1] or not trace["traceEvents"]:
        raise AssertionError(f"event log generations {gens}")
    out = dict(killed_s=t_dead, resumed_s=t_res, uninterrupted_s=t_full,
               rows=full["evaluated_rows"],
               rerun_dispatched=svc["pool_dispatched"],
               rerun_disk_hits=svc["disk"]["hits"], events=len(recs),
               trace_events=len(trace["traceEvents"]))
    print(f"  CLI: SIGKILLed after {CLI_KILL_AFTER} evaluations ({t_dead:.1f}"
          f" s), resumed ({t_res:.1f} s) = uninterrupted ({t_full:.1f} s) "
          f"bit for bit over {len(full['evaluated_rows'])} rows; cache "
          f"re-run: 0 dispatches, {svc['disk']['hits']} disk hits; event "
          f"log: {len(recs)} records in 2 generations, "
          f"{len(trace['traceEvents'])} trace events")
    assert np.isfinite(rerun.y).all()
    return out


def service_phase(dev, res_i, launches_i: dict, by_class_i: dict,
                  card: str) -> dict:
    """The exploration service on the card (ROADMAP queue 1 item 12)."""
    import torch

    from repro_torch import kernels
    from repro_torch.service import service_tuner
    from repro_torch.soc import VLSIFlow

    t_phase = time.perf_counter()
    print("the exploration service (paper protocol, n_pool 2500, resnet50, "
          "T 20):")
    # q = 1, inline: the main incremental soc_tuner run bit for bit, with
    # the same launches (the counting window as drive()'s)
    kernels.reset_launches()
    t0 = time.perf_counter()
    space, pool, ref = _main_inputs(dev)
    r1 = service_tuner(space, pool, VLSIFlow(space, MAIN["workload"],
                                             device=dev),
                       workload=MAIN["workload"], T=MAIN["T"], q=1,
                       executor="inline", reference_front=ref,
                       seed=MAIN["seed"], device=dev, **_protocol())
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    launches, by = launch_counts()
    _same_trajectory("  service_tuner q=1 inline vs the main incremental "
                     "soc_tuner: rows", r1, res_i)
    if launches != launches_i or by != by_class_i:
        raise AssertionError(f"service q=1 launches {launches} {by}; the "
                             f"main incremental run's {launches_i} "
                             f"{by_class_i}")
    print(f"  q=1 inline: {wall1:.1f} s, final ADRS "
          f"{r1.history[-1]['adrs']:.5f} (the main run's, bit for bit); "
          f"launches equal the main run's by shape and class: {launches}")
    out = dict(q1=dict(wall_s=wall1, adrs=r1.history[-1]["adrs"],
                       launches=launches, by_class=by))
    out["async"] = service_async(dev, space, pool, ref, r1, card)
    out["fleet"] = service_fleet(dev, space, pool)
    out["server"] = service_server(dev, space, pool)
    out["cli"] = service_cli(dev, space, pool)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  service phase: {out['wall_s']:.1f} s")
    return out


# --------------------------------------------------------------------------
# The paper's §IV comparison (ROADMAP queue 1 item 13): six baselines at the
# paper protocol (Fig. 7(a)), the simplified model's gap (Fig. 4(c)) and the
# balanced optimum's area breakdown (Fig. 7(b)).
#: K3 at microal's EHVI hypervolumes: a 10-row front plus one sample (m = 3)
#: and a 2-D slab of 6 rows; K2 at microal's GP at its last round (P = 40
#: padded training rows): the posterior cache and ``gp_predict`` over 64
#: candidates; K2 at the uncapped TED's 4500 rows, and ``pairdist_chunked``
#: in 4096-column blocks there
K3_EHVI_SHAPES = [(11, 3), (6, 2)]
K2_MICROAL_SHAPES = [(40, 40), (40, 64)]
K2_CHUNKED = (4500, 4096)
#: the uncapped TED (``ted_select(max_pool=None)``) above ``TED_MAX_POOL``
TED_UNCAPPED_ROWS = 4500


def check_baseline_kernels(dev, results: dict) -> None:
    """K3 and K2 against their plain versions at the baselines phase's new
    launch shapes; ``pairdist_chunked``'s blocks bitwise the monolithic
    launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import pairdist as K2
    from repro_torch.kernels import pareto_count as K3

    rng = np.random.default_rng(20)
    for n, m in K3_EHVI_SHAPES:
        # a front (rows on a curved trade-off) and one dominated sample
        y = rng.dirichlet(np.ones(m), size=n) ** 0.5
        y[-1] = y[0] + 0.01
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        c_k, c_p = K3.dominance_counts(yd), K3.dominance_counts_plain(yd)
        torch.cuda.synchronize()
        _record(results, "pareto_count_ehvi", [n, m],
                float((c_k - c_p).abs().max()), bool(torch.equal(c_k, c_p)),
                time_ms(lambda: K3.dominance_counts(yd)),
                time_ms(lambda: K3.dominance_counts_plain(yd)), None,
                bound_ms(4 * (n * m + n), n * n * K3_OPS_PER_PAIR(m)))
    gen = torch.Generator(device=dev).manual_seed(20)
    for n, m in K2_MICROAL_SHAPES:
        x = torch.rand((n, 26), generator=gen, device=dev)
        y = torch.rand((m, 26), generator=gen, device=dev)
        out_k, out_p = K2.pairdist(x, y), K2.pairdist_plain(x, y)
        torch.cuda.synchronize()
        scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
        atol = 2 * 26 * 2.0 ** -24 * scale  # as check_kernels' K2 lines
        _record(results, "pairdist_microal", [n, m, 26],
                float((out_k - out_p).abs().max()),
                bool(torch.allclose(out_k, out_p, rtol=1e-5, atol=atol)),
                time_ms(lambda: K2.pairdist(x, y)),
                time_ms(lambda: K2.pairdist_plain(x, y)),
                time_ms(lambda: torch.cdist(x, y)),
                bound_ms(4 * ((n + m) * 26 + n * m),
                         2 * n * m * 26 + 3 * n * m + 2 * (n + m) * 26))
    n, chunk = K2_CHUNKED
    x = torch.rand((n, 26), generator=gen, device=dev)
    full, out_p = K2.pairdist(x, x), K2.pairdist_plain(x, x)
    out_k = K2.pairdist_chunked(x, x, chunk=chunk)
    torch.cuda.synchronize()
    atol = 2 * 26 * 2.0 ** -24 * 2 * float((x * x).sum(1).max())
    bound = bound_ms(4 * (2 * n * 26 + n * n),
                     2 * n * n * 26 + 3 * n * n + 4 * n * 26)
    t_plain = time_ms(lambda: K2.pairdist_plain(x, x), reps=5)
    t_lib = time_ms(lambda: torch.cdist(x, x), reps=5)
    _record(results, "pairdist_uncapped", [n, n, 26],
            float((full - out_p).abs().max()),
            bool(torch.allclose(full, out_p, rtol=1e-5, atol=atol)),
            time_ms(lambda: K2.pairdist(x, x), reps=5), t_plain, t_lib, bound)
    bitwise = bool(torch.equal(out_k, full))
    print(f"  pairdist_chunked [{n}, {n}, 26] in {chunk}-column blocks: "
          f"bitwise the monolithic launch: {bitwise}")
    _record(results, "pairdist_uncapped_chunked", [n, n, 26, chunk],
            float((out_k - out_p).abs().max()), bitwise,
            time_ms(lambda: K2.pairdist_chunked(x, x, chunk=chunk), reps=5),
            t_plain, t_lib, bound)
    del full, out_k, out_p
    torch.cuda.empty_cache()


def _microal_probes():
    """Counters patched into ``core.pareto.pareto_mask`` and
    ``core.baselines.hypervolume`` for one run: the mask calls, the
    hypervolume calls, the masks made inside them and their seconds.
    Returns (counts, restore)."""
    import repro_torch.core.baselines as B
    import repro_torch.core.pareto as P

    counts = dict(masks=0, hv_calls=0, hv_masks=0, hv_s=0.0)
    mask_fn, hv_fn = P.pareto_mask, B.hypervolume

    def mask(y):
        counts["masks"] += 1
        return mask_fn(y)

    def hv(*a, **k):
        m0, t0 = counts["masks"], time.perf_counter()
        try:
            return hv_fn(*a, **k)
        finally:
            counts["hv_calls"] += 1
            counts["hv_masks"] += counts["masks"] - m0
            counts["hv_s"] += time.perf_counter() - t0

    P.pareto_mask, B.hypervolume = mask, hv

    def restore():
        P.pareto_mask, B.hypervolume = mask_fn, hv_fn
    return counts, restore


class _RoundProbe:
    """A flow that notes K3's launch count at each call (a round's K3
    launches are the difference between two calls)."""

    def __init__(self, flow):
        self.flow, self.k3 = flow, []

    def __call__(self, idx):
        from repro_torch.kernels import pareto_count as K3

        self.k3.append(K3.launches)
        return self.flow(idx)


def fig7a(dev, space, pool, ref, main_adrs: dict) -> dict:
    """Each baseline once at the paper protocol, every count set to 0 just
    before it: final ADRS, wall seconds, flow evaluations and launches. The
    five non-GP baselines must make K1 = T + 1 and K3 = T + 2 launches and
    evaluate b + T designs; microal's K3 launches are held against its
    mask and hypervolume calls."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import BASELINES, run_baseline
    from repro_torch.random import GeneratorDraws
    from repro_torch.soc import VLSIFlow

    T, b = MAIN["T"], MAIN["b"]
    out = {}
    for name in BASELINES:
        flow = _RoundProbe(VLSIFlow(space, MAIN["workload"], device=dev))
        counts, restore = _microal_probes()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            r = run_baseline(name, space, pool, flow, T=T, b=b,
                             reference_front=ref,
                             draws=GeneratorDraws(MAIN["seed"], dev),
                             device=dev)
        finally:
            restore()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by = launch_counts()
        ev = flow.flow.evaluated
        final = r.history[-1]["adrs"]
        if len(r.history) != T + 1 or ev != b + T or \
                len(set(r.evaluated_rows.tolist())) != b + T or \
                not np.isfinite(r.y).all() or not np.isfinite(final):
            raise AssertionError(f"{name}: a bad result ({ev} evaluations, "
                                 f"{len(r.history)} records)")
        if launches["systolic_eval"] != T + 1:
            raise AssertionError(f"{name}: K1 launched "
                                 f"{launches['systolic_eval']} times, the "
                                 f"protocol makes {T + 1}")
        rec = dict(adrs=final, wall_s=wall, evaluated=ev, launches=launches,
                   by_shape=by, history=[h["adrs"] for h in r.history])
        if name == "microal":
            # between two flow calls: a round's logged front and the next
            # pick's proposal (its front and the EHVI hypervolumes)
            per_round = np.diff(flow.k3)
            fronts = 2 * T + 2  # the logged, the per-round and final fronts
            if launches["pareto_count"] != counts["masks"] or \
                    counts["masks"] - counts["hv_masks"] != fronts:
                raise AssertionError(f"microal: K3 {launches['pareto_count']}"
                                     f", mask calls {counts}")
            rec.update(counts, k3_per_round=per_round.tolist(),
                       hv_share=counts["hv_s"] / wall)
            print(f"  microal: K3 {launches['pareto_count']} = "
                  f"{counts['masks']} mask calls = {fronts} fronts + "
                  f"{counts['hv_masks']} inside {counts['hv_calls']} "
                  f"hypervolumes ({counts['hv_s']:.2f} s, "
                  f"{100 * rec['hv_share']:.1f} % of the run); K3 a round "
                  f"{per_round.tolist()}")
        elif launches["pareto_count"] != T + 2:
            raise AssertionError(f"{name}: K3 launched "
                                 f"{launches['pareto_count']} times, the "
                                 f"protocol makes {T + 2}")
        out[name] = rec
        print(f"  {name:<10s} final ADRS {final:.5f}, {wall:.2f} s, "
              f"{ev} evaluations; K1 {by['systolic_eval']}, K2 "
              f"{by['pairdist']}, K3 {by['pareto_count']}")
    print(f"  SoC-Tuner at the same budget: final ADRS "
          f"{main_adrs['exact']:.5f} (exact), "
          f"{main_adrs['incremental']:.5f} (incremental)")
    return out


def baselines_card_vs_cpu() -> None:
    """At ``SMALL``'s n_pool = 64, each baseline on the card and on the CPU
    with the same draws (made on the CPU): the evaluated rows equal."""
    import numpy as np
    import torch

    from repro_torch.core import BASELINES, make_space, pareto_front, \
        run_baseline
    from repro_torch.random import GeneratorDraws
    from repro_torch.soc import VLSIFlow

    space = make_space()
    gen = torch.Generator().manual_seed(SMALL["seed"])
    pool = space.sample(gen, SMALL["n_pool"]).numpy()
    for name in BASELINES:
        runs = {}
        for d in ("cuda", "cpu"):
            ref = pareto_front(VLSIFlow(space, SMALL["workload"],
                                        device=d)(pool), device=d)
            runs[d] = run_baseline(
                name, space, pool, VLSIFlow(space, SMALL["workload"],
                                            device=d),
                T=SMALL["T"], b=SMALL["b"], reference_front=ref,
                draws=GeneratorDraws(SMALL["seed"], "cpu"), device=d)
        compare_rows(f"  baseline small check (n_pool=64, T=6, {name}): "
                     f"cuda rows", runs["cuda"], runs["cpu"])
        np.testing.assert_allclose(runs["cuda"].history[-1]["adrs"],
                                   runs["cpu"].history[-1]["adrs"], rtol=1e-5)


def uncapped_ted(dev) -> dict:
    """``ted_select(max_pool=None)`` at ``TED_UNCAPPED_ROWS`` designs: the
    kernel matrix from one K2 launch, the card's rows equal to the CPU's."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import make_space
    from repro_torch.core.sampling import ted_select

    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(4500), TED_UNCAPPED_ROWS)
    x = space.encode(idx)
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = ted_select(x.to(dev), b=MAIN["b"], max_pool=None)
    wall = time.perf_counter() - t0
    launches, by = launch_counts()
    n = TED_UNCAPPED_ROWS
    if by["pairdist"] != {f"{n}x{n}x26 d2": 1}:
        raise AssertionError(f"uncapped TED: K2 {by['pairdist']}, expected "
                             f"one {n} x {n} launch")
    cpu = ted_select(x, b=MAIN["b"], max_pool=None)
    print(f"  uncapped TED, {TED_UNCAPPED_ROWS} rows, b {MAIN['b']}: "
          f"{wall:.2f} s, K2 {by['pairdist']}; rows {rows.tolist()}")
    if not np.array_equal(rows, cpu):
        raise AssertionError(f"uncapped TED: the CPU's rows {cpu.tolist()}")
    return dict(wall_s=wall, launches=launches["pairdist"],
                by_shape=by["pairdist"])


#: Fig. 4(c)'s rounds over SimplifiedFlow (MAIN's 20 before the query-shard
#: checks were added; the gap is read from the front after them)
FIG4C_T = 10


def fig4c(dev, space, pool, ref, adrs_full: float) -> dict:
    """``soc_tuner`` (exact, FIG4C_T rounds) over ``SimplifiedFlow``, its
    front re-evaluated with ``VLSIFlow``: the believed-against-actual gap.
    The simplified flow launches no K1."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core import adrs, pareto_front, soc_tuner
    from repro_torch.soc import SimplifiedFlow, VLSIFlow

    simp = SimplifiedFlow(space, MAIN["workload"], device=dev)
    simp_ref = pareto_front(SimplifiedFlow(space, MAIN["workload"],
                                           device=dev)(pool), device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = soc_tuner(space, pool, simp, T=FIG4C_T, reference_front=simp_ref,
                    seed=MAIN["seed"], device=dev, **_protocol())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = launch_counts()
    if launches["systolic_eval"]:
        raise AssertionError(f"SimplifiedFlow: K1 launched "
                             f"{launches['systolic_eval']} times")
    believed = res.pareto_y
    actual = VLSIFlow(space, MAIN["workload"], device=dev)(
        res.pareto_idx(pool))
    gap = float(np.mean(np.abs(actual - believed)
                        / np.maximum(np.abs(actual), 1e-9)))
    a_simp = adrs(ref, actual)
    if not (np.isfinite(actual).all() and np.isfinite(gap)):
        raise AssertionError("Fig. 4(c): non-finite metrics")
    print(f"  Fig. 4(c): soc_tuner over SimplifiedFlow {wall:.1f} s, "
          f"{simp.evaluated} evaluations, K1 0, launches {launches}; front "
          f"of {len(believed)}: mean relative error of the simplified "
          f"model {100 * gap:.1f} %; ADRS of its picks (full metrics) "
          f"{a_simp:.5f} against {adrs_full:.5f} for SoC-Tuner on the full "
          f"flow")
    return dict(wall_s=wall, front=len(believed), rel_error=gap,
                adrs_simplified=a_simp, adrs_full=adrs_full,
                launches=launches)


def fig7b(dev, space, pool, res) -> dict:
    """``area_breakdown`` of the main exact run's balanced optimum (the
    smallest normalized distance to the front's ideal point); the parts
    times the NoC overhead equal the design's area from K1."""
    import numpy as np
    import torch

    from repro_torch.soc import CONST, area_breakdown

    front = res.pareto_y
    z = (front - front.min(0)) / np.maximum(np.ptp(front, 0), 1e-12)
    pick = int(np.argmin(np.linalg.norm(z, axis=1)))
    idx = res.pareto_idx(pool)[pick]
    parts = area_breakdown(torch.as_tensor(space.values(idx[None, :]),
                                           dtype=torch.float32, device=dev))
    total = float(sum(v[0] for v in parts.values()))
    area = float(front[pick, 2])
    ok = bool(np.isclose(total * CONST["noc_overhead"], area, rtol=1e-4,
                         atol=0))
    print(f"  Fig. 7(b): balanced optimum (lat={front[pick, 0]:.3f} ms, "
          f"p={front[pick, 1]:.1f} mW, a={area:.4f} mm2); parts x "
          f"{CONST['noc_overhead']} = {total * CONST['noc_overhead']:.4f} "
          f"mm2: {ok}")
    rows = sorted(((k, float(v[0])) for k, v in parts.items()),
                  key=lambda kv: -kv[1])
    for k, v in rows:
        print(f"    {k:<14s} {v:8.4f} mm2 {100 * v / total:5.1f} %")
    if not ok:
        raise AssertionError("Fig. 7(b): the parts do not sum to K1's area")
    return dict(design=front[pick].tolist(), parts=dict(rows), total=total)


def baselines_phase(dev, res, main_adrs: dict, card: str) -> dict:
    """The §IV comparison on the card at the paper protocol."""
    t_phase = time.perf_counter()
    print(f"the paper's §IV comparison (n_pool {MAIN['n_pool']}, "
          f"{MAIN['workload']}, T {MAIN['T']}, b {MAIN['b']}, seed "
          f"{MAIN['seed']}) [{card}]:")
    space, pool, ref = _main_inputs(dev)
    out = dict(fig7a=fig7a(dev, space, pool, ref, main_adrs))
    baselines_card_vs_cpu()
    out["uncapped_ted"] = uncapped_ted(dev)
    out["fig4c"] = fig4c(dev, space, pool, ref, main_adrs["exact"])
    out["fig7b"] = fig7b(dev, space, pool, res)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"  baselines phase: {out['wall_s']:.1f} s")
    return out


def k5_pairs(S: int, window=None, causal: bool = True) -> int:
    """The (query, key) pairs K5's mask leaves a (b, h): key j of query i
    when j <= i and, with a window W, j > i - W; S(S+1)/2 without one,
    W(W+1)/2 + (S - W)·W with one shorter than S; S² without the causal
    mask."""
    if not causal:
        return S * S
    W = min(window or S, S)
    return W * (W + 1) // 2 + (S - W) * W


def k5_bytes_ops(B, S, H, K, dqk, dv, window=None, causal: bool = True,
                 elem_bytes: int = 2) -> tuple[int, int]:
    """Bytes K5 must move (q [.., H, dqk], k [.., K, dqk], v [.., K, dv]
    and o [.., H, dv], each once; bf16 unless ``elem_bytes`` says) and its
    operations 2·B·H·pairs·(dqk + dv) (the QKᵀ and PV products, 2
    operations a multiply-add, over the unmasked pairs of ``k5_pairs``)."""
    return (elem_bytes * B * S * (H * dqk + K * dqk + K * dv + H * dv),
            2 * B * H * k5_pairs(S, window, causal) * (dqk + dv))


def _demangle(names: list[str]) -> list[str]:
    """Short kernel names (``flash_attn_tc_kernel<128>``) by ``c++filt``,
    or the mangled names where it is missing."""
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    short = [re.search(r"(\w+(?:<[^>]*>)?)\(", d) for d in out]
    return [m.group(1) if m else d for m, d in zip(short, out)]


def ptxas_report(log: str) -> dict:
    """Registers, stack and spills of each kernel entry in the ``-Xptxas -v``
    log of the build, and ptxas's notes of lost performance (``wgmma``
    serialized), keyed by short kernel name."""
    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Potential Performance Loss: (.*) (?:in|for) the "
                      r"function '([^']+)'", line)
        if m:
            entries.setdefault(m.group(2), {})["performance_loss"] = m.group(1)
            continue
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            entries.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            entries[cur].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entries[cur]["static_smem"] = int(m.group(1)) if m else 0
    return dict(zip(_demangle(list(entries)), entries.values()))


def sass_counts(lib: Path, opcodes=("HGMMA", "UTMALDG")) -> dict:
    """How many of each SASS opcode every kernel of the built library holds
    (``cuobjdump --dump-sass``), keyed by short kernel name."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = shutil.which("cuobjdump") or str(Path(home) / "bin" / "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = dict.fromkeys(opcodes, 0)
        elif cur is not None:
            for op in opcodes:
                counts[cur][op] += bool(re.search(rf"\b{op}\b", line))
    return dict(zip(_demangle(list(counts)), counts.values()))


def k5_build_report() -> dict:
    """The bf16 K5 kernel as built, at each (q·k, v) head-dim pair: ptxas's
    registers, stack and spills, its dynamic shared memory, and its
    ``wgmma`` (HGMMA) and TMA load (UTMALDG) instructions in the SASS.
    Raises if a pair's kernel holds no HGMMA or no UTMALDG, or spills."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as K5

    ptxas = ptxas_report(build.build_log())
    sass = sass_counts(build.library_path())
    lib = build.library()
    report = {}
    for dqk, dv in K5.HEAD_DIMS:
        name = f"flash_attn_tc_kernel<{dqk}, {dv}>"
        regs, ops = ptxas.get(name, {}), sass.get(name, {})
        hd = f"{dqk}x{dv}"
        report[hd] = dict(regs, smem_bytes=lib.flash_attn_tc_smem_bytes(
            dqk, dv), **ops)
        print(f"  {name}: {regs.get('registers')} registers, "
              f"{regs.get('stack')} bytes stack, {regs.get('spill_stores')}/"
              f"{regs.get('spill_loads')} bytes spill stores/loads, "
              f"{report[hd]['smem_bytes']} bytes dynamic shared memory; SASS: "
              f"{ops.get('HGMMA', 0)} HGMMA, {ops.get('UTMALDG', 0)} UTMALDG"
              + (f"; ptxas: {regs['performance_loss']}"
                 if "performance_loss" in regs else ""))
        if not (ops.get("HGMMA") and ops.get("UTMALDG")):
            raise AssertionError(f"{name}: no wgmma (HGMMA) or no TMA load "
                                 f"(UTMALDG) in its SASS: {ops}")
        if regs.get("spill_stores") or regs.get("spill_loads"):
            raise AssertionError(f"{name} spills registers: {regs}")
    return report


def k2k4_build_report() -> dict:
    """The redesigned K4 (``round_kernel<RPT>``: 4 rows a lane, or 1 for
    block updates of up to 8 rows) and K2 (``pairdist_kernel<TM>``) as
    built: ptxas's registers, stack, spills and static shared memory,
    and K4's plan, with its dynamic shared memory, at each ``K4_SHAPES``
    entry (d = 26). Raises if a kernel is missing from the build log."""
    from repro_torch.kernels import build
    from repro_torch.kernels import round_fused as K4

    ptxas = ptxas_report(build.build_log())
    names = ["round_kernel<4>", "round_kernel<1>"] + [
        f"pairdist_kernel<{tm}>" for tm in (8, 4, 2, 1)]
    report = {}
    for name in names:
        if name not in ptxas:
            raise AssertionError(f"{name} is not in the build log")
        r = ptxas[name]
        report[name] = r
        print(f"  {name}: {r.get('registers')} registers, {r.get('stack')} "
              f"bytes stack, {r.get('spill_stores')}/{r.get('spill_loads')} "
              f"bytes spill stores/loads, {r.get('static_smem')} bytes static "
              "shared memory")
    for nc, C, P, s0 in K4_SHAPES:
        plan = K4.launch_plan(nc, C, 26, 3, P, s0)
        report[f"round_fused {[nc, C, P, s0]}"] = plan
        print(f"  round_fused plan at {[nc, C, 26, 3, P, 10, s0]}: "
              f"{plan['threads']} threads, {plan['ct']} columns x "
              f"{plan['w']} objectives a tile, {plan['tiles']} tiles, L "
              f"{('resident', 'ring', 'device')[plan['lmode']]} (panels of "
              f"{plan['R']} rows), {plan['smem_bytes']} bytes dynamic shared "
              "memory")
    return report


def k1k3_build_report() -> dict:
    """The redesigned K1 (``systolic_eval_kernel<KR>``: KR layers a lane in
    registers, 0 for shared memory) and K3 (``pareto_count_kernel<M, R>``:
    M objectives, R rows a thread) as
    built: ptxas's registers, stack, spills and static shared memory, and
    their plans at ``K1_SHAPES`` and ``K3_SHAPES``. Raises if a kernel is
    missing from the build log."""
    from repro_torch.kernels import build
    from repro_torch.kernels import pareto_count as K3
    from repro_torch.kernels import systolic_eval as K1
    from repro_torch.soc.workloads import get_workload

    ptxas = {k.replace(" ", ""): v
             for k, v in ptxas_report(build.build_log()).items()}
    names = [f"systolic_eval_kernel<{kr}>" for kr in (0, 1, 2, 4)] + [
        f"pareto_count_kernel<{m},{r}>" for m in range(1, 9)
        for r in (2, 4)]
    report = {}
    for name in names:
        if name not in ptxas:
            raise AssertionError(f"{name} is not in the build log")
        r = report[name] = ptxas[name]
        print(f"  {name}: {r.get('registers')} registers, {r.get('stack')} "
              f"bytes stack, {r.get('spill_stores')}/{r.get('spill_loads')} "
              f"bytes spill stores/loads, {r.get('static_smem')} bytes static "
              "shared memory")
    for workload, n in K1_SHAPES:
        L = len(get_workload(workload))
        plan = report[f"systolic_eval {[n, L]}"] = K1.launch_plan(n, L)
        print(f"  systolic_eval plan at {[n, 26, L]}: {plan['g']} lanes a "
              f"design, {plan['kr'] or 'no'} layers a lane in registers, "
              f"{plan['threads']} threads x {plan['blocks']} blocks, "
              f"{plan['smem_bytes']} bytes dynamic shared memory")
    for n in K3_SHAPES:
        plan = report[f"pareto_count {[n, 3]}"] = K3.launch_plan(n, 3)
        print(f"  pareto_count plan at {[n, 3]}: {plan['rows_per_block']} "
              f"rows a block ({plan['row_threads']} row threads of "
              f"{plan['rows_per_thread']} rows x {plan['splits']} splits = "
              f"{plan['threads']} threads), {plan['blocks']} blocks, "
              f"{plan['tiles']} tile(s) of {plan['tile_rows']} rows, "
              f"{plan['smem_bytes']} bytes dynamic shared memory")
    return report


def check_flash_attn(dev, results: dict) -> None:
    """K5 against its plain version at ``K5_SHAPES`` (bf16), timed beside
    the plain version and ``scaled_dot_product_attention`` (the library
    call, timed only: the port never calls it; its scale is 1/√Dqk too, and
    it takes Dv ≠ Dqk). A causal shape gives SDPA ``is_causal=True``; a
    window shape gives it the window as an explicit boolean ``attn_mask``
    [S, S] (``is_causal`` cannot express a window), and the record says
    which (``library``). The other head dims are kept by ``K5_NAMES``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as K5

    def library(q, k, v, mask):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=mask is None, enable_gqa=True)

    route, _, source = K5.ROUTES[torch.bfloat16]
    for B, S, H, K, dqk, dv, window in K5_SHAPES:
        g = torch.Generator(device=dev).manual_seed(B * S + H)
        q = torch.randn((B, S, H, dqk), generator=g, device=dev).bfloat16()
        k = torch.randn((B, S, K, dqk), generator=g, device=dev).bfloat16()
        v = torch.randn((B, S, K, dv), generator=g, device=dev).bfloat16()
        mask = None
        if window:  # key j of query i: j <= i and j > i - window
            ones = torch.ones((S, S), dtype=torch.bool, device=dev)
            mask = ones.tril() & ~ones.tril(-window)
        before = K5.route_launches[route]
        out_k = K5.flash_attention(q, k, v, window=window)
        if K5.route_launches[route] != before + 1:
            raise AssertionError(f"a bf16 flash_attn call did not take the "
                                 f"{route} route")
        out_p = K5.flash_attention_plain(q, k, v, window=window)
        out_l = library(q, k, v, mask).transpose(1, 2)
        torch.cuda.synchronize()
        err = float((out_k.float() - out_p.float()).abs().max())
        ok = bool(torch.allclose(out_k.float(), out_p.float(), rtol=K5_RTOL,
                                 atol=K5_ATOL))
        lib_err = float((out_l.float() - out_p.float()).abs().max())
        n_bytes, n_ops = k5_bytes_ops(B, S, H, K, dqk, dv, window)
        name = K5_NAMES.get((dqk, dv), "flash_attn")
        lib_call = "sdpa(attn_mask)" if window else "sdpa(is_causal)"
        _record(results, name, [B, S, H, K, dqk, dv, window], err, ok,
                time_ms(lambda: K5.flash_attention(q, k, v, window=window),
                        reps=5, repeats=5),
                time_ms(lambda: K5.flash_attention_plain(q, k, v,
                                                         window=window),
                        reps=2, repeats=3),
                time_ms(lambda: library(q, k, v, mask), reps=5, repeats=5),
                bound_ms(n_bytes, n_ops, PEAK_BF16_OPS_S),
                bound_f32_ms=bound_ms(n_bytes, n_ops)[0],
                library_max_abs_err=lib_err, library=lib_call,
                k5_route=route, source="src/repro_torch/csrc/" + source)
        print(f"    ({route} route, src/repro_torch/csrc/{source}; float32 "
              f"CUDA-core bound "
              f"{results[name][-1]['bound_f32_ms']:.3f} ms; library "
              f"{lib_call}, its max abs err against the plain version "
              f"{lib_err:.3e})")
        del q, k, v, out_k, out_p, out_l, mask
        torch.cuda.empty_cache()


#: float32 K5 against its plain version: sums in another order
K5_F32_RTOL = K5_F32_ATOL = 2e-5


def check_flash_attn_noncausal(dev, results: dict) -> None:
    """K5 with ``causal=False`` against its plain version at
    ``K5_NONCAUSAL_SHAPES``, on both routes (bf16: the tensor cores,
    ``flash_attn_noncausal``; float32: the CUDA cores,
    ``flash_attn_noncausal_f32``), timed beside the plain version and
    ``scaled_dot_product_attention(is_causal=False)``; the bound counts all
    S² pairs. At a ragged S the planted fault "keys past S take softmax
    mass" (the plain softmax over K/V zero-padded to a multiple of 128,
    unmasked, as the reference's Pallas wrapper computes it) is measured
    against the same tolerance and must be rejected at S 65 and 100."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as K5

    def library(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=False, enable_gqa=True)

    for B, S, H, K, hd in K5_NONCAUSAL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            route, _, source = K5.ROUTES[dtype]
            bf16 = dtype == torch.bfloat16
            rtol, atol = (K5_RTOL, K5_ATOL) if bf16 else (K5_F32_RTOL,
                                                          K5_F32_ATOL)
            g = torch.Generator(device=dev).manual_seed(B * S + H + hd)
            q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
            k = torch.randn((B, S, K, hd), generator=g, device=dev).to(dtype)
            v = torch.randn((B, S, K, hd), generator=g, device=dev).to(dtype)
            before = (K5.route_launches[route], K5.class_launches["noncausal"])
            out_k = K5.flash_attention(q, k, v, causal=False)
            if (K5.route_launches[route],
                    K5.class_launches["noncausal"]) != (before[0] + 1,
                                                        before[1] + 1):
                raise AssertionError(f"a {dtype} causal=False flash_attn "
                                     f"call did not launch on the {route} "
                                     "route as a non-causal launch")
            out_p = K5.flash_attention_plain(q, k, v, causal=False)
            out_l = library(q, k, v).transpose(1, 2)
            torch.cuda.synchronize()
            err = float((out_k.float() - out_p.float()).abs().max())
            ok = bool(torch.allclose(out_k.float(), out_p.float(), rtol=rtol,
                                     atol=atol))
            lib_err = float((out_l.float() - out_p.float()).abs().max())
            fault = {}
            Sp = -(-S // 128) * 128
            if Sp > S:  # keys past S, zero-filled and unmasked
                def pad(t):
                    return torch.cat([t, t.new_zeros((B, Sp - S) +
                                                     t.shape[2:])], dim=1)
                out_f = K5.flash_attention_plain(q, pad(k), pad(v),
                                                 causal=False)
                fault = dict(
                    fault_max_abs_err=float((out_f.float() - out_p.float())
                                            .abs().max()),
                    fault_rejected=not bool(torch.allclose(
                        out_f.float(), out_p.float(), rtol=rtol, atol=atol)))
                print(f"    planted fault, keys {S}..{Sp - 1} (zeros) take "
                      f"softmax mass: max abs err "
                      f"{fault['fault_max_abs_err']:.3e}, rejected by the "
                      f"tolerance: {fault['fault_rejected']}")
                if S in (65, 100) and not fault["fault_rejected"]:
                    raise AssertionError(f"the planted fault (zero keys past "
                                         f"S = {S}) passes the K5 check")
                del out_f
            n_bytes, n_ops = k5_bytes_ops(B, S, H, K, hd, hd, causal=False,
                                          elem_bytes=2 if bf16 else 4)
            name = "flash_attn_noncausal" + ("" if bf16 else "_f32")
            _record(results, name, [B, S, H, K, hd, hd, "causal=False"], err,
                    ok,
                    time_ms(lambda: K5.flash_attention(q, k, v, causal=False),
                            reps=5, repeats=5),
                    time_ms(lambda: K5.flash_attention_plain(q, k, v,
                                                             causal=False),
                            reps=2, repeats=3),
                    time_ms(lambda: library(q, k, v), reps=5, repeats=5),
                    bound_ms(n_bytes, n_ops,
                             PEAK_BF16_OPS_S if bf16 else PEAK_F32_OPS_S),
                    library_max_abs_err=lib_err,
                    library="sdpa(is_causal=False)", k5_route=route,
                    source="src/repro_torch/csrc/" + source, **fault)
            print(f"    ({route} route, src/repro_torch/csrc/{source}; "
                  f"library sdpa(is_causal=False), its max abs err against "
                  f"the plain version {lib_err:.3e})")
            del q, k, v, out_k, out_p, out_l
            torch.cuda.empty_cache()


#: K5's backward (B, S, H, KV heads, head dim): starcoder2-3b's training
#: shape, qwen3-100m's (the example's: B 16, S 128, 8/4 heads of 64),
#: ragged S 100 and 2000 (partial 64-row tiles), S 4096 at the dense
#: prefill's heads; then the design's edges: a group of 16 query heads on
#: one KV head (8 splits of 2 heads), S 40 (shorter than a tile), S 333 (a
#: part-filled last chunk, 6 chunks through a 4-stage ring), and a grid of
#: fewer blocks than SMs (16 dK/dV blocks, 8 dQ blocks); last, the shape
#: of pixtral-12b's and phi3.5-moe's training steps (B 2, S 2048, 32/8)
K5_BWD_SHAPES = [(2, 2048, 24, 2, 128), (16, 128, 8, 4, 64),
                 (2, 100, 8, 4, 64), (2, 2000, 24, 2, 128),
                 (1, 4096, 32, 8, 128), (2, 300, 16, 1, 128),
                 (2, 40, 8, 4, 64), (1, 333, 6, 2, 128),
                 (1, 256, 4, 4, 128), (2, 2048, 32, 8, 128)]
#: K5's backward at MLA's head dims (B, S, H, KV heads, Dqk, Dv, the q·k
#: columns in use: past them q and k are 0, and the scale is 1/√ of
#: them): minicpm3-4b's training shape (40 heads, 96 = 64 nope + 32 rope,
#: v 64), deepseek-v2-lite-16b's (16 heads, 192 = 128 + 64, v 128; its
#: dK/dV ring has 3 stages), a ragged S 333 at 192/128, and the MLA smoke
#: dims (q·k 16 + 8 = 24 zero-padded to 32 as the model pads them, scale
#: 1/√24, v 16) at TRAIN_SMOKE's B 4 x S 64 (one full tile; the
#: kernel line's shape) and at S 40 (one partial tile)
K5_BWD_MLA_SHAPES = [(2, 2048, 40, 40, 96, 64, 96),
                     (2, 2048, 16, 16, 192, 128, 192),
                     (1, 333, 16, 16, 192, 128, 192),
                     (4, 64, 4, 4, 32, 16, 24), (2, 40, 4, 4, 32, 16, 24)]
#: the kernel-line names of the backward (and of the training forward,
#: ``flash_attn_train`` + the same suffix) by (Dqk, Dv)
K5_BWD_NAMES = {(128, 128): "", (64, 64): "_64", (96, 64): "_mla",
                (192, 128): "_mla_192", (32, 16): "_mla_32"}
#: the backward's bf16 gradients against the plain float32 ones rounded to
#: bf16: P and dS enter products as bf16 (2^-9 relative) and each output
#: rounds once more. For each of dq, dk, dv: |err| <= rtol |plain| + atol
#: elementwise, atol = max(atol_rel · the largest |plain| of the element's
#: K5_BWD_TILE positions, atol_min) (under the causal mask the gradients
#: shrink about as 1/sqrt(position), so an atol from the whole tensor's
#: largest entry, at the first positions, would pass late positions that
#: are half wrong); and mean |err| <= max(mean_rel · mean |plain|,
#: atol_min). atol_min is the forward's 1e-3, where the exact gradient is
#: 0 (S 1: dS = dP − D cancels to float32 rounding)
K5_BWD_RTOL, K5_BWD_ATOL_REL, K5_BWD_ATOL_MIN = 2.0 ** -6, 2.0 ** -7, 1e-3
K5_BWD_MEAN_REL, K5_BWD_TILE = 2.0 ** -6, 64
#: the forward's row statistic (log2-sum-exp2) against the plain float32
#: logsumexp·log2(e): float32 sums in another order, values up to ~15
K5_LSE_RTOL, K5_LSE_ATOL = 1e-5, 1e-4


def k5_bwd_bytes_ops(B, S, H, K, dqk, dv, window=None,
                     causal: bool = True) -> tuple[int, int]:
    """Bytes K5's backward must move (q, k, v, o, do read and dq, dk, dv
    written once, bf16; the float32 lse read once) and its operations: five
    products over the pairs the mask leaves (``k5_pairs``),
    2·pairs·(3·Dqk + 2·Dv) a (b, h) (Q·Kᵀ, dS·K and dSᵀ·Q contract or span
    Dqk; dO·Vᵀ and Pᵀ·dO, Dv)."""
    n_bytes = 2 * B * S * (2 * (H * dqk + K * dqk + K * dv) + 2 * H * dv) \
        + 4 * B * H * S
    return n_bytes, 2 * B * H * k5_pairs(S, window, causal) * (
        3 * dqk + 2 * dv)


def _bwd_close(got, want) -> tuple[float, float, bool]:
    """(max abs err over dq, dk, dv; the largest ratio of an error to its
    tolerance, elementwise or of the mean; all within the backward
    tolerance)."""
    import torch.nn.functional as F

    err, worst = 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        S, T = w.shape[1], K5_BWD_TILE
        tile_max = F.pad(w.abs().amax(dim=(0, 2, 3)), (0, -S % T)) \
            .view(-1, T).amax(1).repeat_interleave(T)[:S]
        atol = (K5_BWD_ATOL_REL * tile_max).clamp_min(K5_BWD_ATOL_MIN)
        tol = K5_BWD_RTOL * w.abs() + atol.view(1, S, 1, 1)
        mean_tol = max(K5_BWD_MEAN_REL * float(w.abs().mean()),
                       K5_BWD_ATOL_MIN)
        err = max(err, float(d.max()))
        worst = max(worst, float((d / tol).max()), float(d.mean()) / mean_tol)
    return err, worst, worst <= 1.0


#: the training forward's output with its low part (out + out_lo, ~16
#: bits) against the plain float32 output's: P taken as bf16 hi + lo
#: products and float32 sums in another order (the bf16 output alone is
#: 2^-9 off)
K5_HI_LO_RTOL, K5_HI_LO_ATOL = 2.0 ** -12, 1e-4


def _hi_lo_close(out, lo, out_p, lo_p) -> bool:
    """The kernel's out + out_lo within the hi/lo tolerance of the plain
    version's."""
    import torch

    return bool(torch.allclose(out.float() + lo.float(),
                               out_p.float() + lo_p.float(),
                               rtol=K5_HI_LO_RTOL, atol=K5_HI_LO_ATOL))


def bwd_faults_plain(q, k, v, out, dout, lse, scale, window=None,
                     causal: bool = True):
    """The backward with a planted fault, from the plain float32 math and
    the kernel run's ``lse``, under the call's mask (causal, causal over a
    window, or none): ``no_delta`` leaves D out of dS (dS = P∘dP);
    ``last_key_tile`` leaves the last K5_BWD_TILE keys out (a key loop that
    stops a tile early: their dk and dv stay 0 and no row's dq sees them);
    ``late_lse`` rebuilds P from lse + 0.05 in the rows from S/2 on (P 3.4 %
    low there, the rows before exact). The last two touch late positions
    only. Causal: ``mask_shift`` rebuilds P with the mask shifted by one
    key (query i also gets key i + 1, weighted exp2(s·c − lse)). With a
    window: ``window_low``, its lower bound off by one key (query i also
    gets key i − W). Without the causal mask at a ragged S:
    ``keys_past_s``, the last tile's keys at or past S left unmasked in the
    forward and the backward: TMA's zero keys (logit 0, v 0) take softmax
    mass, so the row statistic, P, O and D are those over S padded to a
    tile multiple (the reference's wrapper's mistake, ROADMAP queue 3; a
    backward alone that weighs them still gives every dq 0 from their zero
    k and writes no dk or dv for them). Each returns (dq, dk, dv) in
    bf16."""
    import torch

    from repro_torch.kernels.flash_attn import LOG2E

    B, S, H, dqk = q.shape
    K = k.shape[2]
    G = H // K
    qf = q.float().transpose(1, 2)
    kf = k.repeat_interleave(G, dim=2).float().transpose(1, 2)
    vf = v.repeat_interleave(G, dim=2).float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * (scale * LOG2E)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ones = torch.ones((S, S), dtype=torch.bool, device=q.device)
    pos = torch.arange(S, device=q.device)

    def masked(shift: int = 0, low: int = 0):
        """The call's mask, its causal edge ``shift`` keys later and its
        window's lower edge ``low`` keys earlier."""
        if not causal:
            return ones
        m = ones.tril(shift)
        if window:
            m &= ~ones.tril(-window - low)
        return m

    def grads(p, ds):
        def summed(t):
            return t.view(B, K, G, S, t.shape[-1]).sum(2).transpose(1, 2)
        return (torch.matmul(ds, kf).mul_(scale).transpose(1, 2).bfloat16(),
                summed(torch.matmul(ds.transpose(-1, -2), qf) * scale
                       ).bfloat16(),
                summed(torch.matmul(p.transpose(-1, -2), dof)).bfloat16())

    def softmax(mask, row_lse):
        return torch.where(mask, torch.exp2(s - row_lse[..., None]), 0.0)

    mask = masked()
    out_f = {}
    p = softmax(mask, lse)
    out_f["no_delta"] = grads(p, p * dp)
    last = (S - 1) // K5_BWD_TILE * K5_BWD_TILE
    p = softmax(mask & (pos < last), lse)
    out_f["last_key_tile"] = grads(p, p * (dp - delta))
    p = softmax(mask, lse + 0.05 * (pos >= S // 2))
    out_f["late_lse"] = grads(p, p * (dp - delta))
    if causal:
        p = softmax(masked(shift=1), lse)
        out_f["mask_shift"] = grads(p, p * (dp - delta))
    if causal and window and window < S:
        p = softmax(masked(low=1), lse)
        out_f["window_low"] = grads(p, p * (dp - delta))
    pad = -S % K5_BWD_TILE
    if not causal and pad:
        # pad zero keys each add exp2(0) to the row sum of exp2(s)
        lse_pad = torch.logaddexp2(lse, torch.full_like(lse, math.log2(pad)))
        p = softmax(mask, lse_pad)
        o_pad = torch.matmul(p, vf)                     # [B, H, S, Dv]
        d_pad = (dof * o_pad).sum(-1, keepdim=True)
        out_f["keys_past_s"] = grads(p, p * (dp - d_pad))
    return out_f


#: K5's backward under the masks of the encoder-decoder, the hybrid and the
#: smoke twins (B, S, H, KV heads, Dqk, Dv, window, causal, the kernel-line
#: suffix): whisper-tiny's encoder in a training step (B 2, S 1500, 6/6,
#: 64/64, no causal mask; the last key tile ragged) and a ragged S 100;
#: recurrentgemma-9b's step (B 1, S 4096, 16/1, 256/256, window 2048) and
#: the edge [2, 1000, 16/1, W 100]; the smoke dims 16/16 at the smoke
#: twins' B 4 x S 64, 4/2 heads, causal, with their window of 32 and
#: without the causal mask
K5_BWD_MASK_SHAPES = [(2, 1500, 6, 6, 64, 64, None, False, "_noncausal"),
                      (2, 100, 4, 4, 64, 64, None, False, "_noncausal"),
                      (1, 4096, 16, 1, 256, 256, 2048, True, "_window"),
                      (2, 1000, 16, 1, 256, 256, 100, True, "_window"),
                      (4, 64, 4, 2, 16, 16, None, True, "_16"),
                      (4, 64, 4, 2, 16, 16, 32, True, "_16"),
                      (4, 64, 4, 2, 16, 16, None, False, "_16")]
#: planted faults the tolerance cannot see at a shape, printed there and
#: not required: at S 1500 the 36 zero keys of the last tile take ~1.5 % of
#: each row's mass (P scaled by ~0.985 everywhere), inside the relative
#: tolerance 2^-6 (measured on the CPU: 0.81 of it); at S 100 (28 zero
#: keys of 128) the same fault is 9.4 times the tolerance, and required
K5_BWD_FAULT_UNSEEN = {("keys_past_s", (2, 1500, 6, 6, 64, 64))}




def k5_bwd_cases() -> list[tuple]:
    """Every case of :func:`check_flash_attn_backward`, in order: (B, S, H,
    KV heads, Dqk, Dv, the q·k columns in use, window, causal, the
    kernel-line suffix) from ``K5_BWD_SHAPES`` and ``K5_BWD_MLA_SHAPES``
    (causal, no window) and ``K5_BWD_MASK_SHAPES``."""
    return ([(B, S, H, K, hd, hd, hd, None, True, K5_BWD_NAMES[(hd, hd)])
             for B, S, H, K, hd in K5_BWD_SHAPES]
            + [(B, S, H, K, dqk, dv, used, None, True, K5_BWD_NAMES[(dqk, dv)])
               for B, S, H, K, dqk, dv, used in K5_BWD_MLA_SHAPES]
            + [(B, S, H, K, dqk, dv, dqk, W, causal, suffix)
               for B, S, H, K, dqk, dv, W, causal, suffix
               in K5_BWD_MASK_SHAPES])


def k5_bwd_inputs(dev, B, S, H, K, dqk, dv, used) -> tuple:
    """(q, k, v, dout, scale) of a backward case, bf16 from a seed: q and k
    zero past the ``used`` q·k columns, the scale 1/√used."""
    import torch

    g = torch.Generator(device=dev).manual_seed(B * S + H + 7)
    q, k, v = (torch.randn((B, S, n, d), generator=g, device=dev)
               .bfloat16() for n, d in ((H, dqk), (K, dqk), (K, dv)))
    q[..., used:] = 0
    k[..., used:] = 0
    dout = torch.randn((B, S, H, dv), generator=g, device=dev).bfloat16()
    return q, k, v, dout, 1.0 / math.sqrt(used)


def sdpa_mask(S: int, window, causal: bool, dev) -> tuple[dict, str]:
    """The keyword arguments that give ``scaled_dot_product_attention``
    K5's mask (``is_causal``, or a boolean ``attn_mask`` for the window),
    and their text."""
    import torch

    if window:
        pos = torch.arange(S, device=dev)
        return (dict(attn_mask=(pos[None, :] <= pos[:, None])
                     & (pos[None, :] > pos[:, None] - window)),
                "a boolean attn_mask of the window")
    return dict(is_causal=causal), f"is_causal={causal}"


def sdpa_backward(q, k, v, dout, scale: float, mask: dict) -> tuple:
    """The backward of ``scaled_dot_product_attention(..., enable_gqa=True,
    **mask)`` alone, the library yardstick of K5's (the port never calls
    it): its forward runs once, outside the timing, on a side stream, so
    that autograd (which runs each backward op on its forward op's stream)
    issues the backward where :func:`time_ms` captures it in a CUDA graph;
    timed as K5's backward is. Returns ((device, eager) ms, its dq, dk, dv
    in [B, S, H, D], the backend PyTorch picks)."""
    import torch
    import torch.nn.functional as F

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    do_t = dout.transpose(1, 2)
    try:
        from torch.nn.attention import SDPBackend

        backend = SDPBackend(torch._fused_sdp_choice(
            qt, kt, vt, scale=scale, enable_gqa=True, **mask)).name
    except Exception as e:  # a PyTorch without the private chooser
        backend = f"unknown ({type(e).__name__})"
    with torch.cuda.stream(stream):
        o = F.scaled_dot_product_attention(qt, kt, vt, scale=scale,
                                           enable_gqa=True, **mask)
    torch.cuda.current_stream().wait_stream(stream)

    def library():
        return torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True)

    grads = [t.transpose(1, 2) for t in library()]
    return time_ms(library, reps=5, repeats=5, stream=stream), grads, backend


def check_flash_attn_backward(dev, results: dict) -> None:
    """K5's backward (``csrc/flash_attn_bwd.cu``) against its plain version
    under the same mask at every case of :func:`k5_bwd_cases` (causal at
    Dqk = Dv and at MLA's dims; without the causal mask, with a window, and
    at the (16, 16) and (256, 256) instances): the tile-scaled and mean
    tolerance, a second call bitwise equal to the first (its ``bwd_plan``
    printed), the forward's row statistic against the plain logsumexp and
    its output with its low part; the planted faults of
    :func:`bwd_faults_plain` under the mask, each of which the tolerance
    must reject, but those of ``K5_BWD_FAULT_UNSEEN`` (printed); timed
    beside the plain version and the backward of
    ``scaled_dot_product_attention`` under the same mask
    (:func:`sdpa_backward`). The training forward with its row statistic
    is recorded beside it."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as K5

    for B, S, H, K, dqk, dv, used, W, causal, suffix in k5_bwd_cases():
        at = [B, S, H, K, dqk, dv] + ([f"q·k {used}"] if used < dqk else []) \
            + (["no causal mask"] if not causal else
               [f"window {W}"] if W else [])
        q, k, v, dout, scale = k5_bwd_inputs(dev, B, S, H, K, dqk, dv, used)
        before = (K5.launches, K5.bwd_launches)
        out_k, lse_k, lo_k = K5.flash_attention_lse(q, k, v, scale, W,
                                                    causal)
        got = K5.flash_attention_backward(q, k, v, out_k, lse_k, dout, scale,
                                          W, causal, out_lo=lo_k)
        if (K5.launches, K5.bwd_launches) != (before[0] + 1, before[1] + 1):
            raise AssertionError("flash_attention_lse/backward did not "
                                 "launch once each")
        out_p, lse_p, lo_p = K5.flash_attention_lse_plain(q, k, v, scale, W,
                                                          causal)
        want = K5.flash_attention_backward_plain(q, k, v, dout, scale, W,
                                                 causal)
        torch.cuda.synchronize()
        lse_err = float((lse_k - lse_p).abs().max())
        lse_ok = bool(torch.allclose(lse_k, lse_p, rtol=K5_LSE_RTOL,
                                     atol=K5_LSE_ATOL))
        out_ok = bool(torch.allclose(out_k.float(), out_p.float(),
                                     rtol=K5_RTOL, atol=K5_ATOL)) and \
            _hi_lo_close(out_k, lo_k, out_p, lo_p)
        err, worst, ok = _bwd_close(got, want)
        again = K5.flash_attention_backward(q, k, v, out_k, lse_k, dout,
                                            scale, W, causal, out_lo=lo_k)
        repeats = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        plan = K5.bwd_plan(B, S, H, K, dqk, dv)
        errs = {n: float((a.float() - b.float()).abs().max())
                for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        print(f"  backward {at} (plan {plan}; a second call bitwise equal: "
              f"{repeats}): max abs err {errs} (max |plain| "
              f"{[round(float(w.float().abs().max()), 4) for w in want]}), "
              f"largest error / tolerance {worst:.3f}; lse max abs err "
              f"{lse_err:.3e} ok={lse_ok}; forward out ok={out_ok}")
        if not repeats:
            raise AssertionError(f"K5's backward at {at}: two calls on the "
                                 "same inputs differ")
        if not (lse_ok and out_ok):
            raise AssertionError(f"K5 forward at {at}: the lse "
                                 f"({lse_err:.3e}) or the output disagrees "
                                 "with the plain version")
        faults = {}
        for name, f_grads in bwd_faults_plain(q, k, v, out_k, dout, lse_k,
                                              scale, W, causal).items():
            f_err, f_worst, f_ok = _bwd_close(f_grads, want)
            unseen = (name, (B, S, H, K, dqk, dv)) in K5_BWD_FAULT_UNSEEN
            faults[name] = dict(max_abs_err=f_err, err_over_tol=f_worst,
                                rejected=not f_ok, required=not unseen)
            print(f"    planted fault {name}: max abs err {f_err:.3e}, "
                  f"largest error / tolerance {f_worst:.3f}, rejected: "
                  f"{not f_ok}" + (" (not required here: "
                                   "K5_BWD_FAULT_UNSEEN)" if unseen else ""))
            if f_ok and not unseen:
                raise AssertionError(f"the planted backward fault {name} "
                                     f"passes the check at {at}")
        del f_grads
        if "late_lse" not in faults or "last_key_tile" not in faults or \
                (causal and "mask_shift" not in faults) or \
                (W and "window_low" not in faults) or \
                (not causal and S % K5_BWD_TILE and
                 "keys_past_s" not in faults):
            raise AssertionError(f"a planted fault is missing at {at}")

        mask, mask_txt = sdpa_mask(S, W, causal, dev)
        t_lib, lib_grads, backend = sdpa_backward(q, k, v, dout, scale, mask)
        lib_err = _bwd_close(lib_grads, want)[0]
        del lib_grads
        n_bytes, n_ops = k5_bwd_bytes_ops(B, S, H, K, dqk, dv, W, causal)
        lib_txt = f"sdpa({mask_txt}, enable_gqa) backward"
        _record(results, "flash_attn_bwd" + suffix, at, err, ok,
                time_ms(lambda: K5.flash_attention_backward(
                    q, k, v, out_k, lse_k, dout, scale, W, causal,
                    out_lo=lo_k), reps=5, repeats=5),
                time_ms(lambda: K5.flash_attention_backward_plain(
                    q, k, v, dout, scale, W, causal), reps=1, repeats=3),
                t_lib, bound_ms(n_bytes, n_ops, PEAK_BF16_OPS_S),
                grad_max_abs_err=errs, err_over_tol=worst,
                lse_max_abs_err=lse_err, plan=plan, faults=faults,
                library_max_abs_err=lib_err,
                library=f"{lib_txt}, backend {backend}",
                source="src/repro_torch/csrc/flash_attn_bwd.cu")
        print(f"    (library: the {lib_txt}, backend {backend}; its max abs "
              f"err against the plain version {lib_err:.3e})")
        # the training forward: K5 with its row statistic
        n_bytes, n_ops = k5_bytes_ops(B, S, H, K, dqk, dv, W, causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        _record(results, "flash_attn_train" + suffix, at + ["lse"],
                float((out_k.float() - out_p.float()).abs().max()), out_ok,
                time_ms(lambda: K5.flash_attention_lse(q, k, v, scale, W,
                                                       causal),
                        reps=5, repeats=5),
                time_ms(lambda: K5.flash_attention_lse_plain(
                    q, k, v, scale, W, causal), reps=1, repeats=3),
                time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, scale=scale, enable_gqa=True, **mask),
                    reps=5, repeats=5),
                bound_ms(n_bytes + 4 * B * H * S, n_ops, PEAK_BF16_OPS_S),
                lse_max_abs_err=lse_err, library=f"sdpa({mask_txt})",
                source="src/repro_torch/csrc/flash_attn_tc.cu")
        del q, k, v, dout, out_k, lse_k, lo_k, got, want, out_p, lse_p, lo_p
        del qt, kt, vt, mask
        torch.cuda.empty_cache()


# ------------------------------------------------------------ query shards
#: K5 on the query shard of a sequence-parallel cell (B, Sk, Sq, H, KV
#: heads, Dqk, Dv, window, causal, the offsets held against the unsharded
#: call): the model-level check's own shard (starcoder2-3b at SHARDED's S
#: 2048 on two ranks: rank 1's 1024 rows); qwen3-14b's prefill_32k shard
#: on the production 16-way model axis (2048 of 32768 positions: the
#: last, the first and a middle shard); starcoder2-3b's and minicpm3-4b's
#: train_4k shards (256 of 4096, the last; MLA's 96/64 at 40/40 heads); a
#: small shape whose window (100) is shorter than the shard and whose
#: offset (437) is off the 64- and 128-row tiles; one without the causal
#: mask. Every shard of a shape runs in the backward (their dk/dv are
#: summed); the listed ones are held against the plain version.
K5_QSHARD_SHAPES = [
    (2, 2048, 1024, 24, 2, 128, 128, None, True, (1024,)),
    (2, 32768, 2048, 40, 8, 128, 128, None, True, (30720, 0, 14336)),
    (2, 4096, 256, 24, 2, 128, 128, None, True, (3840,)),
    (2, 4096, 256, 40, 40, 96, 64, None, True, (3840,)),
    (2, 1000, 200, 16, 1, 256, 256, 100, True, (437,)),
    (2, 1500, 300, 6, 6, 64, 64, None, False, (600,))]


def k5_shard_pairs(Sk: int, Sq: int, o: int, window=None,
                   causal: bool = True) -> int:
    """The (query, key) pairs K5's mask leaves a (b, h) of a query shard:
    row i at position o + i sees keys max(0, o + i - W + 1) … o + i (all
    Sk without the causal mask)."""
    if not causal:
        return Sq * Sk
    W = window or Sk
    return sum(p - max(0, p - W + 1) + 1 for p in range(o, o + Sq))


def k5_shard_bytes_ops(B, Sk, Sq, o, H, K, dqk, dv, window=None,
                       causal: bool = True, backward: bool = False
                       ) -> tuple[int, int]:
    """Bytes and operations of K5 (or, with ``backward``, of its backward)
    on a query shard, as ``k5_bytes_ops`` / ``k5_bwd_bytes_ops`` count
    them: q and o (the backward: q, dq, o and do) of the Sq rows, k and v
    (the backward: and dk, dv) of all Sk keys, each moved once in bf16 (and
    the float32 lse of the Sq rows in the backward); the operations over
    the shard's pairs (``k5_shard_pairs``)."""
    pairs = k5_shard_pairs(Sk, Sq, o, window, causal)
    q, out = B * Sq * H * dqk, B * Sq * H * dv
    kv = B * Sk * K * (dqk + dv)
    if not backward:
        return 2 * (q + kv + out), 2 * B * H * pairs * (dqk + dv)
    return (2 * (2 * q + 2 * kv + 2 * out) + 4 * B * H * Sq,
            2 * B * H * pairs * (3 * dqk + 2 * dv))


def _by_kv_heads(fn, q, k, v, *rest, groups: int = 8):
    """The plain version ``fn(q, k, v, *rest)`` run over slices of the KV
    heads (each with its query heads; ``rest`` tensors [B, S, H, ·] are
    sliced like q), at most ``groups`` slices, joined on the heads: the same
    values, in memory a qwen3-14b prefill_32k shard's [B, H, Sq, Sk]
    float32 logits (21 GB) would not leave for the softmax's temporaries."""
    import torch

    H, K = q.shape[2], k.shape[2]
    step = -(-K // groups)
    outs = []
    for g0 in range(0, K, step):
        g1 = min(K, g0 + step)
        h0, h1 = g0 * H // K, g1 * H // K
        outs.append(fn(q[:, :, h0:h1], k[:, :, g0:g1], v[:, :, g0:g1],
                       *(t[:, :, h0:h1] for t in rest)))
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=2)
    return tuple(torch.cat(parts, dim=2) for parts in zip(*outs))


def shard_mask(Sq: int, Sk: int, o: int, window, causal: bool, dev) -> dict:
    """``scaled_dot_product_attention``'s keyword arguments for K5's mask of
    a query shard: a boolean ``attn_mask`` [Sq, Sk] (SDPA's ``is_causal``
    aligns its diagonal top-left when Sq ≠ Sk), or none without the causal
    mask."""
    import torch

    if not causal:
        return dict(is_causal=False)
    qpos = o + torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return dict(attn_mask=mask)


def _shard_pieces(Sk: int, Sq: int, o: int) -> list[tuple[int, int]]:
    """Contiguous (offset, rows) pieces of Sq rows (shorter at the ends)
    that cover [0, Sk) and include the shard at ``o``."""
    cuts = sorted({0, Sk} | set(range(o % Sq, Sk, Sq)))
    return [(a, b - a) for a, b in zip(cuts, cuts[1:])]


def check_flash_attn_query_shards(dev, results: dict) -> None:
    """K5 on query shards (``K5_QSHARD_SHAPES``), forward and backward.
    Forward: each listed shard against rows o … o + Sq of the unsharded K5
    call (bit for bit, or K5's tolerance where not) and against the plain
    version with the offset (K5's tolerance); the offset a tile short (o -
    64) must fail that tolerance. Backward: every piece of the sequence
    (``_shard_pieces``) through K5's backward with its offset; their dq
    against the unsharded backward's rows (bit for bit, or the backward's
    tolerance), their dk/dv summed in piece order against the unsharded
    dk/dv (the backward's tolerance); each listed shard against the plain
    backward with the offset (the backward's tolerance), twice bitwise
    equal, and its o - 64 run rejected. Timed beside the plain version
    (over KV-head slices, ``_by_kv_heads``) and SDPA under the offset's
    boolean mask; bounds over the shard's pairs (``k5_shard_pairs``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attn as K5

    def sdpa(q, k, v, mask, scale):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale, enable_gqa=True, **mask).transpose(1, 2)

    for B, Sk, Sq, H, K, dqk, dv, W, causal, offsets in K5_QSHARD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(Sk + Sq + H)
        q, k, v, dout = (torch.randn((B, Sk, n, d), generator=g,
                                     device=dev).bfloat16()
                         for n, d in ((H, dqk), (K, dqk), (K, dv), (H, dv)))
        scale = dqk ** -0.5
        at = [B, f"Sq {Sq} of Sk {Sk}", H, K, dqk, dv] + (
            ["no causal mask"] if not causal else
            [f"window {W}"] if W else [])
        full = K5.flash_attention(q, k, v, scale, W, causal)
        for o in offsets:
            qs = q[:, o:o + Sq].contiguous()
            before = K5.class_launches["query_shard"]
            got = K5.flash_attention(qs, k, v, scale, W, causal, q_offset=o)
            if K5.class_launches["query_shard"] != before + 1:
                raise AssertionError("a query-shard call was not counted")
            rows = full[:, o:o + Sq]
            bitwise = bool(torch.equal(got, rows))
            rows_ok = bitwise or bool(torch.allclose(
                got.float(), rows.float(), rtol=K5_RTOL, atol=K5_ATOL))
            want = _by_kv_heads(lambda a, b, c: K5.flash_attention_plain(
                a, b, c, scale, W, causal, o), qs, k, v)
            err = float((got.float() - want.float()).abs().max())
            ok = rows_ok and bool(torch.allclose(
                got.float(), want.float(), rtol=K5_RTOL, atol=K5_ATOL))
            fault = None
            if causal and o >= 64:
                short = K5.flash_attention(qs, k, v, scale, W, causal,
                                           q_offset=o - 64)
                fault = float((short.float() - want.float()).abs().max())
                if torch.allclose(short.float(), want.float(), rtol=K5_RTOL,
                                  atol=K5_ATOL):
                    raise AssertionError(f"K5 at offset {o} - 64 passes the "
                                         f"check at {at}")
            print(f"  query shard {at} at offset {o}: the unsharded call's "
                  f"rows {'bit for bit' if bitwise else 'within tolerance'}"
                  f" ({rows_ok}); max abs err against the plain version "
                  f"{err:.3e}" + ("" if fault is None else
                                  f"; the offset a tile short: {fault:.3e}, "
                                  "rejected"))
            if o == offsets[0]:
                mask = shard_mask(Sq, Sk, o, W, causal, dev)
                n_bytes, n_ops = k5_shard_bytes_ops(B, Sk, Sq, o, H, K, dqk,
                                                    dv, W, causal)
                _record(results, "flash_attn_qshard",
                        at + [f"offset {o}"], err, ok,
                        time_ms(lambda: K5.flash_attention(
                            qs, k, v, scale, W, causal, q_offset=o),
                            reps=5, repeats=5),
                        time_ms(lambda: _by_kv_heads(
                            lambda a, b, c: K5.flash_attention_plain(
                                a, b, c, scale, W, causal, o), qs, k, v),
                            reps=1, repeats=3),
                        time_ms(lambda: sdpa(qs, k, v, mask, scale), reps=5,
                                repeats=5),
                        bound_ms(n_bytes, n_ops, PEAK_BF16_OPS_S),
                        bitwise_unsharded_rows=bitwise,
                        offset_short_err=fault,
                        library="sdpa(boolean attn_mask of the offset)"
                        if causal else "sdpa(is_causal=False)",
                        source="src/repro_torch/csrc/flash_attn_tc.cu")
            elif not ok:
                raise AssertionError(f"K5's query shard at offset {o} of {at}"
                                     " disagrees")
            del got, want, rows, qs
        del full

        # the backward: every piece, the listed shards against the plain
        out, lse, lo = K5.flash_attention_lse(q, k, v, scale, W, causal)
        fdq, fdk, fdv = K5.flash_attention_backward(q, k, v, out, lse, dout,
                                                    scale, W, causal,
                                                    out_lo=lo)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dvs = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        dq_bitwise = True
        for o, n in _shard_pieces(Sk, Sq, offsets[0]):
            qs, ds = q[:, o:o + n].contiguous(), dout[:, o:o + n].contiguous()
            so, sl, slo = K5.flash_attention_lse(qs, k, v, scale, W, causal,
                                                 o)
            before = K5.bwd_class_launches["query_shard"]
            got = K5.flash_attention_backward(qs, k, v, so, sl, ds, scale, W,
                                              causal, out_lo=slo, q_offset=o)
            if K5.bwd_class_launches["query_shard"] != before + 1:
                raise AssertionError("a query-shard backward was not counted")
            rows = fdq[:, o:o + n]
            if not torch.equal(got[0], rows):
                dq_bitwise = False
                if not _bwd_close((got[0],), (rows,))[2]:
                    raise AssertionError(f"dq of the piece at {o} of {at} is "
                                         "not the unsharded call's rows")
            dk += got[1].float()
            dvs += got[2].float()
            if o in offsets:
                want = _by_kv_heads(
                    lambda a, b, c, d: K5.flash_attention_backward_plain(
                        a, b, c, d, scale, W, causal, o), qs, k, v, ds)
                err, worst, ok = _bwd_close(got, want)
                again = K5.flash_attention_backward(
                    qs, k, v, so, sl, ds, scale, W, causal, out_lo=slo,
                    q_offset=o)
                repeats = all(torch.equal(a, b) for a, b in zip(got, again))
                fault = None
                if causal and o >= 64:
                    short = K5.flash_attention_backward(
                        qs, k, v, so, sl, ds, scale, W, causal, out_lo=slo,
                        q_offset=o - 64)
                    fault = _bwd_close(short, want)
                    if fault[2]:
                        raise AssertionError(f"K5's backward at offset {o} - "
                                             f"64 passes the check at {at}")
                print(f"  query shard backward {at} at offset {o}: largest "
                      f"error / tolerance {worst:.3f} (max abs err "
                      f"{err:.3e}); a second call bitwise equal: {repeats}"
                      + ("" if fault is None else
                         f"; the offset a tile short: error / tolerance "
                         f"{fault[1]:.3f}, rejected"))
                if not (ok and repeats):
                    raise AssertionError(f"K5's backward at offset {o} of "
                                         f"{at} disagrees or does not repeat")
                if o == offsets[0]:
                    mask = shard_mask(n, Sk, o, W, causal, dev)
                    t_lib, _, backend = sdpa_backward(qs, k, v, ds, scale,
                                                      mask)
                    n_bytes, n_ops = k5_shard_bytes_ops(
                        B, Sk, n, o, H, K, dqk, dv, W, causal, backward=True)
                    _record(results, "flash_attn_bwd_qshard",
                            at + [f"offset {o}"], err, ok,
                            time_ms(lambda: K5.flash_attention_backward(
                                qs, k, v, so, sl, ds, scale, W, causal,
                                out_lo=slo, q_offset=o), reps=5, repeats=5),
                            time_ms(lambda: _by_kv_heads(
                                lambda a, b, c, d:
                                K5.flash_attention_backward_plain(
                                    a, b, c, d, scale, W, causal, o),
                                qs, k, v, ds), reps=1, repeats=3),
                            t_lib, bound_ms(n_bytes, n_ops, PEAK_BF16_OPS_S),
                            err_over_tol=worst, offset_short_err_over_tol=(
                                None if fault is None else fault[1]),
                            library=f"sdpa backward ({backend}), "
                            + ("boolean attn_mask of the offset" if causal
                               else "is_causal=False"),
                            source="src/repro_torch/csrc/flash_attn_bwd.cu")
                del want, again
            del got, qs, ds, so, sl, slo
        err, worst, ok = _bwd_close((dk, dvs), (fdk, fdv))
        print(f"  query shard backward {at}: "
              f"{len(_shard_pieces(Sk, Sq, offsets[0]))} pieces' dq "
              f"{'bit for bit' if dq_bitwise else 'within tolerance'} the "
              f"unsharded rows; their dk/dv summed against the unsharded: "
              f"largest error / tolerance {worst:.3f}")
        if not ok:
            raise AssertionError(f"the pieces' dk/dv of {at} do not sum to "
                                 "the unsharded call's")
        results["flash_attn_bwd_qshard"][-1]["pieces_dkdv_err_over_tol"] = \
            worst
        del q, k, v, dout, out, lse, lo, fdq, fdk, fdv, dk, dvs
        torch.cuda.empty_cache()


def k5_bwd_build_report() -> dict:
    """The backward's two kernels (``bwd_dq_kernel``, ``bwd_dkdv_kernel``)
    as built, at each pair of ``BWD_HEAD_DIMS``: ptxas's registers, stack
    and spills, their dynamic shared memory, and their ``wgmma`` (HGMMA)
    and TMA load (UTMALDG) instructions in the SASS. Raises if a kernel is
    missing or holds no HGMMA or no UTMALDG."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attn as K5

    ptxas = ptxas_report(build.build_log())
    sass = sass_counts(build.library_path())
    lib = build.library()
    report = {}
    for dqk, dv in K5.BWD_HEAD_DIMS:
        for which, kernel in enumerate(("bwd_dq_kernel", "bwd_dkdv_kernel")):
            name = f"{kernel}<{dqk}, {dv}>"
            if name not in ptxas:
                raise AssertionError(f"{name} is not in the build log")
            regs, ops = ptxas[name], sass.get(name, {})
            report[name] = dict(regs, smem_bytes=lib.flash_attn_bwd_smem_bytes(
                dqk, dv, which), **ops)
            print(f"  {name}: {regs.get('registers')} registers, "
                  f"{regs.get('stack')} bytes stack, {regs.get('spill_stores')}"
                  f"/{regs.get('spill_loads')} bytes spill stores/loads, "
                  f"{report[name]['smem_bytes']} bytes dynamic shared memory; "
                  f"SASS: {ops.get('HGMMA', 0)} HGMMA, {ops.get('UTMALDG', 0)} "
                  f"UTMALDG" + (f"; ptxas: {regs['performance_loss']}"
                                if "performance_loss" in regs else ""))
            if not (ops.get("HGMMA") and ops.get("UTMALDG")):
                raise AssertionError(f"{name}: no wgmma (HGMMA) or no TMA "
                                     f"load (UTMALDG) in its SASS: {ops}")
    return report


#: the training phase. qwen3-100m (examples/train_lm_torch.py's config:
#: qwen3-14b narrowed to 12 layers, d 512, 8/4 heads of 64, d_ff 1408,
#: vocab 32064, remat off) on the bigram stream for TRAIN_STEPS steps,
#: cut at TRAIN_CUT and resumed; starcoder2-3b at its published width,
#: first 4 layers (K5 gradients against the plain attention's), then all
#: 30 (B 2 x S 2048, remat on as configured) for TRAIN_TIMED timed steps.
TRAIN_DATA = dict(seq_len=128, global_batch=16, seed=0)
TRAIN_STEPS, TRAIN_CUT, TRAIN_CPU_STEPS = 50, 20, 3
TRAIN_LR = dict(base=1e-3, warmup=10, total=TRAIN_STEPS)
TRAIN_FULL = dict(arch="starcoder2-3b", batch=2, seq=2048, grad_layers=4,
                  timed=3)
#: the vision, MLA and MoE families at their published widths, cut in
#: depth, at TRAIN_FULL's B 2 x S 2048 with remat: one step's gradients
#: with K5 against the same step with K5's plain version (pixtral-12b with
#: random patch embeddings in its 1024 patch slots of the 2048; the MoE
#: configs' expert choices replayed layer by layer)
TRAIN_GRAD_FAMILIES = [dict(arch="pixtral-12b", layers=4),
                       dict(arch="minicpm3-4b", layers=4),
                       dict(arch="phi3.5-moe-42b-a6.6b", layers=2),
                       dict(arch="deepseek-v2-lite-16b", layers=4)]
#: timed steps as TRAIN_FULL's: minicpm3-4b at its published width and
#: depth (4.262 B parameters, ~68.2 GB of state); deepseek-v2-lite-16b at
#: its published width, cut to its dense layer and 6 of its 26 MoE layers
#: (a MoE layer holds ~9.4 GB of state, the embedding and head ~6.7 GB:
#: ~64 GB of state, room for the step's activations in 80 GB)
TRAIN_FULL_MLA = dict(TRAIN_FULL, arch="minicpm3-4b")
TRAIN_FULL_MOE_MLA = dict(TRAIN_FULL, arch="deepseek-v2-lite-16b", layers=7)
#: the encoder-decoder, the hybrid and SSM at their published widths, with
#: remat: K5's gradients against the plain attention's, leaf by leaf, as
#: TRAIN_GRAD_FAMILIES (whisper-tiny whole, 4 encoder and 4 decoder layers,
#: B 2 x S 448 over random frames [2, 1500, 384]; recurrentgemma-9b cut to
#: 3 periods, 9 of its 38 layers, B 1 x S 4096: past its window of 2048),
#: then timed steps as TRAIN_FULL's, whisper-tiny whole, recurrentgemma-9b
#: cut to 6 layers (2 periods: at 9 layers, 3.87 B parameters and ~62 GB of
#: state, AdamW's float32 temporaries of the 1.05 B-parameter embedding ran
#: the card out of memory) and mamba2-370m whole (0.37 B, B 2 x S 2048, the
#: SSD in its chunks of 256; no K5; its step issues ~72,000 launches)
TRAIN_GRAD_NEW = [dict(arch="whisper-tiny", layers=None, batch=2, seq=448),
                  dict(arch="recurrentgemma-9b", layers=9, batch=1,
                       seq=4096)]
TRAIN_FULL_AUDIO = dict(arch="whisper-tiny", batch=2, seq=448, timed=3)
TRAIN_FULL_HYBRID = dict(arch="recurrentgemma-9b", batch=1, seq=4096,
                         layers=6, timed=3)
TRAIN_FULL_SSM = dict(arch="mamba2-370m", batch=2, seq=2048, timed=3)
#: the smoke twin of every config, through launch/train.py as a user runs
#: it (the launcher's own example is qwen3-14b's twin; the dense, vision
#: and MoE twins take K5 at 16/16, the hybrid's with its window of 32 at S
#: 64, the MLA twins at (32, 16): q·k 16 + 8 zero-padded to 32, v 16;
#: mamba2's none), and whisper's through make_train_step with random
#: frames (the launcher's bigram stream has none); with the card-vs-CPU
#: first-step gradients of the SSM, hybrid and encoder-decoder twins
TRAIN_SMOKE = dict(archs=("qwen3-14b", "mistral-nemo-12b", "starcoder2-3b",
                          "pixtral-12b", "phi3.5-moe-42b-a6.6b",
                          "minicpm3-4b", "deepseek-v2-lite-16b",
                          "recurrentgemma-9b", "mamba2-370m"),
                   steps=4, batch=4, seq=64)
TRAIN_SMOKE_MLA = ("minicpm3-4b", "deepseek-v2-lite-16b")
TRAIN_SMOKE_CPU = ("mamba2-370m", "recurrentgemma-9b", "whisper-tiny")
#: the loss of the same step on the card and on the CPU (same masters and
#: tokens): bf16 rounds in other places (cuBLAS and the CPU's GEMMs, K5
#: against _sdpa) and the masters part where a gradient near 0 takes the
#: other sign; measured 1.4e-4 over the first 3 steps (both runs repeat
#: bit for bit). A dead attention gradient moves these 3 losses by only
#: 1.1e-3 to 1.3e-3 (on the CPU, wq/wk/wv given zero gradients), so the
#: first step's gradients are compared too, leaf by leaf
TRAIN_CPU_LOSS_ATOL = 1e-3
#: starcoder2-3b's gradients with K5 against the plain attention, leaf by
#: leaf: the kernel's bf16 P and dS (2^-9) and its forward's one-ulp output
#: flips carry through 4 layers (the CPU parity tests, 2 layers: <= 0.013
#: of a leaf's max and 0.009 of its mean): max |diff| <= 2^-4 max |plain|,
#: mean |diff| <= 2^-5 mean |plain|
TRAIN_GRAD_ATOL_REL, TRAIN_GRAD_MEAN_REL = 2.0 ** -4, 2.0 ** -5
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
#: kernel groups of the full-width step's profile
TRAIN_KERNEL_GROUPS = {
    "k5_forward": r"flash_attn_tc_kernel",
    # (bwd_dq_kernel and bwd_dkdv_kernel; the rest are an older tree's, for
    # tools/kernel_timing.py --train)
    "k5_backward": r"dkdv_kernel|dq_kernel|delta_kernel|group_sum_kernel",
    "gemm": r"nvjet|gemm|cutlass|sm90_|cublas",
    "elementwise": r"elementwise|vectorized|reduce_kernel|Reduce"}


def qwen3_100m():
    """examples/train_lm_torch.py's (and examples/train_lm.py's) config."""
    from repro_torch.configs import get_config

    return dataclasses.replace(
        get_config("qwen3-14b"), arch_id="qwen3-100m", n_layers=12,
        d_model=512, n_heads=8, n_kv_heads=4, head_dim=64, d_ff=1408,
        vocab=32064, remat=False)


def _state_equal(a, b) -> bool:
    import torch

    return int(a.step) == int(b.step) and all(
        torch.equal(getattr(a, part)[k], getattr(b, part)[k])
        for part in ("params", "m", "v") for k in a.params)


def train_small(dev) -> dict:
    """qwen3-100m on the bigram stream: TRAIN_STEPS steps with every count
    set to 0 just before (K5 forward and backward at (64, 64): 12 of each a
    step); the loss must fall by >= 0.2 below its first record and stay
    above the bigram floor - 0.05; a run cut at TRAIN_CUT (its checkpoint
    written as the drill writes it) and resumed must end with masters and
    moments equal to the uninterrupted run's bit for bit; and the first
    TRAIN_CPU_STEPS losses on the CPU from the same masters within
    TRAIN_CPU_LOSS_ATOL; the first step's gradients (K5 forward and
    backward at (64, 64)) against the CPU's leaf by leaf within the
    TRAIN_GRAD tolerances, every leaf nonzero, with K5 on detached q/k/v
    (wq, wk and wv given no gradient) as a planted fault that the check
    must reject."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.train import (DataConfig, LRSchedule, TrainConfig,
                                   bigram_entropy, init_params,
                                   make_batch, make_train_step, train)
    from repro_torch.train.optimizer import adamw_init

    t_phase = time.perf_counter()
    cfg = qwen3_100m()
    dcfg = DataConfig(vocab=cfg.vocab, **TRAIN_DATA)
    floor = bigram_entropy(dcfg)
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def init_fn():  # fresh copies: a run updates its masters in place
        return {k: v.to(dev, copy=True) for k, v in masters.items()}

    tcfg = TrainConfig(steps=TRAIN_STEPS, log_every=1,
                       lr=LRSchedule(**TRAIN_LR))
    print(f"  {cfg.arch_id}: {sum(v.numel() for v in masters.values()) / 1e6:.1f}"
          f" M parameters, bigram floor {floor:.4f}, B {dcfg.global_batch} "
          f"x S {dcfg.seq_len}, {TRAIN_STEPS} steps")
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, hist = train(cfg, tcfg, dcfg, init_fn, verbose=False, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(forward=K5.launches, backward=K5.bwd_launches,
                    backward_by_dims={f"{a}x{b}": n for (a, b), n in
                                      K5.bwd_head_dim_launches.items()})
    losses = [h["loss"] for h in hist]
    print(f"  uninterrupted: {wall:.1f} s ({1e3 * wall / TRAIN_STEPS:.1f} ms a "
          f"step), loss {losses[0]:.4f} -> {losses[-1]:.4f} (min "
          f"{min(losses):.4f}), K5 launches {launches}")
    print(f"  loss every 10 steps: {[round(x, 4) for x in losses[9::10]]}")
    want = cfg.n_layers * TRAIN_STEPS
    if (launches["forward"], launches["backward"]) != (want, want) or \
            launches["backward_by_dims"] != {
                f"{cfg.head_dim}x{cfg.head_dim}": want}:
        raise AssertionError(f"K5 launched {launches} in {TRAIN_STEPS} steps "
                             f"of {cfg.n_layers} layers; want {want} each")
    if not losses[-1] < losses[0] - 0.2:
        raise AssertionError(f"the loss fell from {losses[0]:.4f} to only "
                             f"{losses[-1]:.4f}")
    if min(losses) <= floor - 0.05:
        raise AssertionError(f"the loss {min(losses):.4f} beat the bigram "
                             f"floor {floor:.4f}")

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    drill = dataclasses.replace(tcfg, ckpt_dir=str(TRAIN_DIR),
                                ckpt_every=TRAIN_STEPS)
    t0 = time.perf_counter()
    train(cfg, drill, dcfg, init_fn, preempt_after=TRAIN_CUT, verbose=False,
          device=dev)
    resumed, _ = train(cfg, drill, dcfg, init_fn, verbose=False, device=dev)
    drill_s = time.perf_counter() - t0
    same = _state_equal(resumed, state)
    print(f"  drill: cut at step {TRAIN_CUT}, resumed to {int(resumed.step)} "
          f"({drill_s:.1f} s): masters and moments equal to the "
          f"uninterrupted run's bit for bit: {same}")
    if not same:
        raise AssertionError("the resumed run's state differs from the "
                             "uninterrupted run's")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)

    step_cpu = make_train_step(cfg, tcfg, "cpu")
    st_cpu = adamw_init({k: v.clone() for k, v in masters.items()})
    cpu_losses = []
    for k in range(TRAIN_CPU_STEPS):
        st_cpu, _, m = step_cpu(st_cpu, make_batch(dcfg, k), None)
        cpu_losses.append(float(m["loss"]))
    diffs = [abs(a - b) for a, b in zip(cpu_losses, losses)]
    print(f"  card vs CPU, first {TRAIN_CPU_STEPS} losses: "
          f"{[round(x, 5) for x in losses[:TRAIN_CPU_STEPS]]} vs "
          f"{[round(x, 5) for x in cpu_losses]} (max |diff| {max(diffs):.2e}, "
          f"tolerance {TRAIN_CPU_LOSS_ATOL})")
    if max(diffs) > TRAIN_CPU_LOSS_ATOL:
        raise AssertionError("the card's losses part from the CPU's")

    batch = make_batch(dcfg, 0)
    names = list(masters)
    g_cpu = [g.to(dev) for g in
             _leaf_grads(_grad_model(cfg, masters, "cpu"), batch)[1]]
    model = _grad_model(cfg, masters, dev)
    batch = {"tokens": batch["tokens"].to(dev)}
    _, g_card = _leaf_grads(model, batch)
    worst, failed, zero = _compare_grads(names, g_card, g_cpu)
    print(f"  card vs CPU, first step's gradients of {len(names)} leaves: "
          f"worst max/mean relative difference {worst[0]:.3e}/{worst[1]:.3e}"
          f" ({worst[2]}); leaves outside {failed}, with no or zero "
          f"gradient {zero}")
    if failed or zero:
        raise AssertionError(f"the card's gradients part from the CPU's: "
                             f"{failed}; zero: {zero}")
    _, g_fault = _leaf_grads(model, batch, _detached_attention)
    _, f_failed, f_zero = _compare_grads(names, g_fault, g_cpu)
    attn = {f"layers.{i}.attn.{w}" for i in range(cfg.n_layers)
            for w in ("wq", "wk", "wv")}
    print(f"  planted fault, K5 on detached q/k/v: leaves outside "
          f"{len(f_failed)} ({len(attn & {n for n, *_ in f_failed})} of the "
          f"{len(attn)} wq/wk/wv), with no or zero gradient {len(f_zero)}; "
          f"rejected: {bool(f_failed or f_zero)}")
    if not attn <= {n for n, *_ in f_failed} | set(f_zero):
        raise AssertionError("the detached-attention fault passes the card "
                             "vs CPU gradient check")
    del model, g_card, g_cpu, g_fault
    torch.cuda.empty_cache()
    return dict(config=cfg.arch_id, steps=TRAIN_STEPS, wall_s=wall,
                step_ms=1e3 * wall / TRAIN_STEPS, losses=losses, floor=floor,
                launches=launches, drill_equal=same, drill_s=drill_s,
                cpu_losses=cpu_losses, cpu_loss_max_diff=max(diffs),
                cpu_grad_worst_max_rel=worst[0],
                cpu_grad_worst_mean_rel=worst[1], cpu_grad_worst_leaf=worst[2],
                phase_s=time.perf_counter() - t_phase)


def _grad_check(g, want) -> tuple[float, float, bool]:
    """(max |diff| / max |want|, mean |diff| / mean |want|, within the
    TRAIN_GRAD tolerances) of one leaf (no gradient counts as 0)."""
    import torch

    want = want.float()
    g = torch.zeros_like(want) if g is None else g.float()
    d = (g - want).abs()
    mx = float(d.max() / want.abs().max().clamp_min(1e-30))
    mn = float(d.mean() / want.abs().mean().clamp_min(1e-30))
    return mx, mn, mx <= TRAIN_GRAD_ATOL_REL and mn <= TRAIN_GRAD_MEAN_REL


def _compare_grads(names, got, want) -> tuple[tuple, list, list]:
    """Leaf by leaf: ((worst max ratio, worst mean ratio, its leaf), the
    leaves outside the TRAIN_GRAD tolerances as (name, max, mean), the
    leaves of ``got`` with no or zero gradient)."""
    worst, failed = (0.0, 0.0, ""), []
    for n, a, b in zip(names, got, want):
        mx, mn, ok = _grad_check(a, b)
        worst = max(worst, (mx, mn, n))
        if not ok:
            failed.append((n, mx, mn))
    zero = [n for n, g in zip(names, got)
            if g is None or not bool(g.abs().max() > 0)]
    return worst, failed, zero


def _grad_model(cfg, masters: dict, dev):
    """A bf16 compute ``LM`` on ``dev`` holding ``masters``, its parameters
    requiring gradients."""
    import torch

    from repro_torch.models.model import LM

    model = LM(cfg, dev)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(masters[n])
            p.requires_grad_(True)
    return model


def _leaf_grads(model, batch: dict, attention=None,
                routing=None) -> tuple[float, tuple]:
    """(the loss, its gradient of every parameter, None where unused)."""
    import torch

    from repro_torch.models import loss_fn

    loss, _ = loss_fn(model, batch, attention=attention, routing=routing)
    return float(loss.detach()), torch.autograd.grad(
        loss, list(model.parameters()), allow_unused=True)


def _plain_attention(q, k, v, scale=None, **kw):
    """K5's plain version as the model's attention (autograd through it)."""
    from repro_torch.kernels import flash_attn as K5

    return K5.flash_attention_plain(q, k, v, scale, **kw)


def _detached_attention(q, k, v, **kw):
    """A planted fault: K5 on detached q, k, v (the autograd Function
    bypassed), so wq, wk and wv get no gradient."""
    from repro_torch.kernels import flash_attn as K5

    return K5.flash_attention(q.detach(), k.detach(), v.detach(), **kw)


def _k5_step_launches(cfg) -> tuple[int, int]:
    """K5's (forward, backward) launches in one loss and gradient of
    ``cfg``: one of each an attention block (none in an SSM or RG-LRU
    block), and under remat the decoder blocks' forwards again in the
    backward (an encoder's blocks run outside remat, as the reference's)."""
    from repro_torch.models import layer_kinds

    n_dec = sum(k not in ("ssm", "rglru") for k in layer_kinds(cfg))
    n_enc = cfg.enc_layers if cfg.is_encdec else 0
    return (2 if cfg.remat else 1) * n_dec + n_enc, n_dec + n_enc


def _with_frames(cfg, batch: dict, seed: int) -> dict:
    """``batch`` and, for an encoder-decoder, random frame embeddings [B,
    enc_len, d] from ``seed`` on the batch's device (the reference's stub
    feeds random frames too)."""
    import torch

    if cfg.is_encdec:
        tok = batch["tokens"]
        batch["frames"] = torch.randn(
            (tok.shape[0], cfg.enc_len, cfg.d_model), device=tok.device,
            generator=torch.Generator(device=tok.device).manual_seed(seed))
    return batch


def train_full_grads(dev, arch: str, n_layers: int | None,
                     conf: dict = TRAIN_FULL) -> dict:
    """``arch`` at its published width, cut to ``n_layers`` layers (None:
    its own depth): one step's gradients (``conf``'s B x S, TRAIN_FULL's 2
    x 2048 by default, remat on; a vision config's patch slots given
    random patch embeddings, an encoder-decoder random frames) with K5
    forward
    and backward against the same step with K5's plain version as the
    attention, leaf by leaf; every leaf's gradient must be nonzero. A MoE
    config's K5 run records each layer's expert choices, which must be the
    same in the forward and in remat's rerun, and the plain run replays
    them layer by layer (on the card the two attentions' bf16 outputs
    part by an ulp and reorder near-tied experts). The planted fault, K5
    called on detached q, k, v (the autograd Function bypassed), must
    leave every self-attention parameter but ``wo`` (an encoder's too)
    without a gradient, which the nonzero check rejects."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.train import DataConfig, init_params, make_batch

    t0 = time.perf_counter()
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    masters = init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                          dev)
    names = list(masters)
    model = _grad_model(cfg, masters, dev)
    del masters
    batch = _with_frames(cfg, make_batch(
        DataConfig(cfg.vocab, conf["seq"], conf["batch"]), 0, device=dev), 3)
    if cfg.frontend == "vision":
        batch["images"] = torch.randn(
            (conf["batch"], cfg.n_patches, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(2))
    moe = bool(cfg.n_experts)
    k_calls, p_calls = {}, {}
    routes = _recorder(k_calls) if moe else None

    before = (K5.launches, K5.bwd_launches)
    loss_k, g_k = _leaf_grads(model, batch, routing=routes)
    moved = (K5.launches - before[0], K5.bwd_launches - before[1])
    replay = _recorder(p_calls, k_calls) if moe else None
    loss_p, g_p = _leaf_grads(model, batch, _plain_attention, replay)
    torch.cuda.synchronize()
    worst, failed, zero = _compare_grads(names, g_k, g_p)
    extra = {}
    if moe:
        rerun_differs = [i for i, c in k_calls.items()
                         if len(c) != 2 or not torch.equal(c[0], c[1])]
        flips = _flip_share([k_calls], [p_calls])
        dropped = _dropped(cfg, k_calls)
        extra = dict(moe_layers=sorted(k_calls), rerun_differs=rerun_differs,
                     plain_own_choice_flips=flips, dropped=dropped)
        print(f"    MoE layers {sorted(k_calls)}: each layer's choices in "
              f"remat's rerun equal its forward's: {not rerun_differs}; the "
              f"plain run's own choices differ from K5's in {flips[0]} of "
              f"{flips[1]} (token, layer) rows (replayed); assignments past "
              f"capacity a layer {dropped}")
        if rerun_differs or sorted(k_calls) != sorted(p_calls):
            raise AssertionError(f"{arch}: remat's rerun chose other "
                                 f"experts in layers {rerun_differs}")
    print(f"  {cfg.arch_id} at full width, {cfg.n_layers} layers"
          + (f" and {cfg.enc_layers} encoder layers over frames [{conf['batch']}"
             f", {cfg.enc_len}, {cfg.d_model}]" if cfg.is_encdec else "")
          + f", B {conf['batch']} x S {conf['seq']}"
          + (f" ({cfg.n_patches} patch slots)" if "images" in batch else "")
          + f": loss K5 {loss_k:.5f}, plain {loss_p:.5f}; K5 launches in the "
          f"step: {moved[0]} forward (with remat), {moved[1]} backward; "
          f"gradients of {len(names)} leaves, worst max/mean relative "
          f"difference {worst[0]:.3e}/{worst[1]:.3e} ({worst[2]}); leaves "
          f"with no or zero gradient: {zero}")
    if failed or zero:
        raise AssertionError(f"{arch}: K5's gradients part from the plain "
                             f"attention's: {failed}; zero: {zero}")
    if moved != _k5_step_launches(cfg):
        raise AssertionError(f"K5 launched {moved} in a step of "
                             f"{cfg.n_layers} layers with remat; want "
                             f"{_k5_step_launches(cfg)}")
    del g_k, g_p
    loss_f, g_f = _leaf_grads(model, batch, _detached_attention,
                              _recorder({}, k_calls) if moe else None)
    dead = [n for n, g in zip(names, g_f)
            if g is None or not bool(g.abs().max() > 0)]
    blocks = [(f"layers.{i}", b) for i, b in enumerate(model.layers)]
    if model.enc_layers is not None:
        blocks += [(f"enc_layers.{g}", b)
                   for g, b in enumerate(model.enc_layers)]
    want_dead = {f"{prefix}.attn.{n}" for prefix, block in blocks
                 if block.attn is not None
                 for n, _ in block.attn.named_parameters() if n != "wo"}
    print(f"  planted fault, K5 on detached q/k/v (the autograd Function "
          f"bypassed): {len(dead)} leaves with no or zero gradient "
          f"({len(want_dead & set(dead))} of the {len(want_dead)} attention "
          f"parameters but wo); rejected: {bool(dead)}")
    if not want_dead <= set(dead):
        raise AssertionError("the detached-attention fault left a gradient "
                             f"on {sorted(want_dead - set(dead))}")
    del g_f, model
    torch.cuda.empty_cache()
    return dict(arch=arch, layers=cfg.n_layers, loss_k5=loss_k,
                loss_plain=loss_p, worst_max_rel=worst[0],
                worst_mean_rel=worst[1], worst_leaf=worst[2],
                launches=moved, fault_dead=dead,
                phase_s=time.perf_counter() - t0, **extra)


def train_full(dev, conf: dict) -> dict:
    """``conf``'s arch (TRAIN_FULL: starcoder2-3b; TRAIN_FULL_MLA:
    minicpm3-4b; TRAIN_FULL_MOE_MLA: deepseek-v2-lite-16b; TRAIN_FULL_AUDIO,
    _HYBRID, _SSM: whisper-tiny, recurrentgemma-9b, mamba2-370m) at its
    published width, at its depth or cut to ``conf["layers"]``, at
    ``conf``'s B x S (an encoder-decoder's batches with random frames),
    remat on: the float32 masters and moments, the bf16 compute copy and
    its gradients on the card; one warm-up step, then the timed steps with
    every count set to 0 just before them (s a step, tokens/s, K5 forward
    and backward launches a step, by mask: with remat, 2 forward and 1
    backward a decoder attention layer, 1 and 1 an encoder layer, none in
    an SSM or RG-LRU layer), the peak memory of the whole run, one forward
    and backward whose every leaf's gradient must be finite (mamba2's SSD
    at its chunk of 256 among them), one more step under torch.profiler
    (the busy share) and, for a MoE config, the assignments past capacity
    in each MoE layer of one forward."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import loss_fn
    from repro_torch.train import (DataConfig, LRSchedule, TrainConfig,
                                   init_params, make_batch, make_train_step)
    from repro_torch.train.optimizer import adamw_init

    cfg = get_config(conf["arch"])
    if conf.get("layers"):
        cfg = dataclasses.replace(cfg, n_layers=conf["layers"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = adamw_init(init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev))
    n_params = sum(p.numel() for p in state.params.values())
    step_fn = make_train_step(cfg, TrainConfig(lr=LRSchedule(
        base=1e-4, warmup=10, total=1000)), dev)
    dcfg = DataConfig(cfg.vocab, conf["seq"], conf["batch"])
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _, m = step_fn(state, _with_frames(
        cfg, make_batch(dcfg, 0, device=dev), 0), None)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    kernels.reset_launches()
    times, losses = [], [float(m["loss"])]
    for k in range(1, 1 + conf["timed"]):
        batch = _with_frames(cfg, make_batch(dcfg, k, device=dev), k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _, m = step_fn(state, batch, None)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    launches = dict(forward=K5.launches / conf["timed"],
                    backward=K5.bwd_launches / conf["timed"],
                    backward_total=K5.bwd_launches,
                    forward_total=K5.launches,
                    forward_by_mask=dict(K5.class_launches),
                    backward_by_mask=dict(K5.bwd_class_launches))
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the step's parts: the masters copied into the compute copy, then its
    # forward and backward (AdamW is the rest of a step)
    model = step_fn.model
    params = list(model.parameters())
    batch = _with_frames(cfg, make_batch(dcfg, 99, device=dev), 99)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(state.params[n])
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grads = torch.autograd.grad(loss_fn(model, batch)[0], params)
    torch.cuda.synchronize()
    fwd_bwd_s = time.perf_counter() - t0
    finite = torch.stack([torch.isfinite(g).all() for g in grads]).cpu()
    not_finite = [n for (n, _), ok in zip(model.named_parameters(), finite)
                  if not ok]
    del grads
    dropped = None
    if cfg.n_experts:
        calls = {}
        with torch.no_grad():
            loss_fn(model, batch, routing=_recorder(calls))
        dropped = _dropped(cfg, calls)
    busy = device_busy(lambda: (step_fn(state, batch, None),
                                torch.cuda.synchronize()), min(times),
                       groups=TRAIN_KERNEL_GROUPS)
    step_s = sorted(times)[len(times) // 2]
    tokens = conf["batch"] * conf["seq"]
    cut = "" if cfg.n_layers == get_config(conf["arch"]).n_layers else \
        f" (cut from {get_config(conf['arch']).n_layers})"
    print(f"  {cfg.arch_id} at full width, {cfg.n_layers} layers{cut} "
          f"({n_params / 1e9:.3f} B parameters), B {conf['batch']} x S "
          f"{conf['seq']}, remat {cfg.remat}: init {init_s:.1f} s, warm-up "
          f"step {warm_s:.2f} s, steps {[round(t, 4) for t in times]} s "
          f"(median {step_s:.4f} s, {tokens / step_s:.0f} tokens/s), losses "
          f"{[round(x, 4) for x in losses]}, peak {peak:.2f} GB, "
          f"{busy['busy_text']}; K5 launches a step: {launches}"
          + ("" if dropped is None else
             f"; assignments past capacity in each MoE layer of one "
             f"forward: {dropped}"))
    print(f"    parts of a step: copy into the compute copy {copy_s:.4f} s, "
          f"forward + backward {fwd_bwd_s:.4f} s, AdamW (the rest of the "
          f"median step) {step_s - copy_s - fwd_bwd_s:.4f} s; device time "
          f"by kernel group: " + ", ".join(
              f"{g} {v['device_s']:.4f} s ({v['launches']})"
              for g, v in busy.get("by_group", {}).items()))
    _print_top(busy)
    print(f"    every leaf's gradient finite in one forward and backward "
          f"({len(finite)} leaves): {not not_finite}")
    want = _k5_step_launches(cfg)
    if (launches["forward"], launches["backward"]) != want:
        raise AssertionError(f"K5 launched {launches} a step; want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if not_finite:
        raise AssertionError(f"non-finite gradients of {not_finite}")
    out = dict(arch=cfg.arch_id, layers=cfg.n_layers, params=n_params,
               dropped=dropped,
               batch=conf["batch"], seq=conf["seq"], remat=cfg.remat,
               init_s=init_s, warm_s=warm_s, step_s=times,
               step_median_s=step_s, tokens_per_s=tokens / step_s,
               losses=losses, peak_gb=peak, launches=launches,
               copy_s=copy_s, fwd_bwd_s=fwd_bwd_s,
               adamw_s=step_s - copy_s - fwd_bwd_s,
               **{k: v for k, v in busy.items() if k != "top_kernels"})
    del state, step_fn, model, params
    torch.cuda.empty_cache()
    return out


def train_smoke_families(dev) -> dict:
    """The smoke twins of TRAIN_SMOKE trained on the card through
    ``launch/train.py``'s ``main`` (whisper-tiny's through
    ``make_train_step`` with random frames), with every count set to 0
    just before each run: K5's launches a step by mask and head dims as
    :func:`_k5_step_launches` says, the losses finite; then, for
    TRAIN_SMOKE_CPU, the first step's gradients on the card against the
    CPU's from the same masters and batch, leaf by leaf within the
    TRAIN_GRAD tolerances, every leaf nonzero and finite."""
    import contextlib
    import io

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.launch.train import main as launch_train
    from repro_torch.train import (DataConfig, TrainConfig, adamw_init,
                                   init_params, make_batch, make_train_step)

    conf = TRAIN_SMOKE
    out = {}
    for arch in conf["archs"] + ("whisper-tiny",):
        cfg = get_config(arch, smoke=True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        if cfg.is_encdec:
            dcfg = DataConfig(cfg.vocab, conf["seq"], conf["batch"])
            st = adamw_init(init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), dev))
            step = make_train_step(cfg, TrainConfig(), dev)
            losses = []
            for k in range(conf["steps"]):
                st, _, m = step(st, _with_frames(
                    cfg, make_batch(dcfg, k, device=dev), k), None)
                losses.append(float(m["loss"]))
            rc = 0
        else:
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                rc = launch_train(["--arch", arch, "--steps",
                                   str(conf["steps"]), "--batch",
                                   str(conf["batch"]), "--seq",
                                   str(conf["seq"])])
            losses = [float(line.split("loss=")[1].split()[0])
                      for line in log.getvalue().splitlines()
                      if "loss=" in line]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(forward=K5.launches, backward=K5.bwd_launches,
                        by_dims={f"{a}x{b}": n for (a, b), n in
                                 K5.bwd_head_dim_launches.items()},
                        backward_by_mask=dict(K5.bwd_class_launches))
        fwd, bwd = (conf["steps"] * n for n in _k5_step_launches(cfg))
        dqk, dv = (-(-(cfg.qk_nope_dim + cfg.qk_rope_dim) // 16) * 16,
                   cfg.v_head_dim) if cfg.attn_kind == "mla" else \
            (cfg.head_dim, cfg.head_dim)
        want = (fwd, bwd, {f"{dqk}x{dv}": bwd} if bwd else {})
        how = "make_train_step with frames" if cfg.is_encdec else \
            "launch/train.py"
        print(f"  {arch}@smoke through {how}, {conf['steps']} steps of B "
              f"{conf['batch']} x S {conf['seq']} ({wall:.1f} s): losses "
              f"{losses}; K5 launches {launches}")
        if rc != 0 or len(losses) != conf["steps"] or \
                not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{arch}@smoke: {how} returned {rc} with "
                                 f"losses {losses}")
        if (launches["forward"], launches["backward"],
                launches["by_dims"]) != want:
            raise AssertionError(f"{arch}@smoke: K5 launched {launches}; "
                                 f"want {want}")
        out[arch] = dict(losses=losses, launches=launches, wall_s=wall)

    for arch in TRAIN_SMOKE_CPU:
        cfg = get_config(arch, smoke=True)
        masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        names = list(masters)
        batch = _with_frames(cfg, make_batch(DataConfig(
            cfg.vocab, conf["seq"], conf["batch"]), 0), 1)
        g_cpu = [g.to(dev) for g in
                 _leaf_grads(_grad_model(cfg, masters, "cpu"), batch)[1]]
        g_card = _leaf_grads(_grad_model(cfg, masters, dev),
                             {k: t.to(dev) for k, t in batch.items()})[1]
        worst, failed, zero = _compare_grads(names, g_card, g_cpu)
        finite = all(bool(torch.isfinite(g).all()) for g in g_card)
        print(f"  {arch}@smoke card vs CPU, first step's gradients of "
              f"{len(names)} leaves: worst max/mean relative difference "
              f"{worst[0]:.3e}/{worst[1]:.3e} ({worst[2]}); leaves outside "
              f"{failed}, with no or zero gradient {zero}, all finite "
              f"{finite}")
        if failed or zero or not finite:
            raise AssertionError(f"{arch}@smoke: the card's gradients part "
                                 f"from the CPU's: {failed}; zero: {zero}")
        out[arch]["card_vs_cpu"] = dict(worst_max_rel=worst[0],
                                        worst_mean_rel=worst[1],
                                        worst_leaf=worst[2])
    return out


def train_phase(dev) -> dict:
    """The training phase: qwen3-100m (loss, drill, card vs CPU), then
    starcoder2-3b's full-width gradients and timed steps; the vision, MLA
    and MoE families' full-width gradients (TRAIN_GRAD_FAMILIES), then
    minicpm3-4b's and deepseek-v2-lite-16b's timed steps; the
    encoder-decoder's and the hybrid's full-width gradients
    (TRAIN_GRAD_NEW), whisper-tiny's, recurrentgemma-9b's and
    mamba2-370m's timed steps, and every smoke twin (TRAIN_SMOKE)."""
    t0 = time.perf_counter()
    out = dict(small=train_small(dev),
               grads=train_full_grads(dev, TRAIN_FULL["arch"],
                                      TRAIN_FULL["grad_layers"]),
               full=train_full(dev, TRAIN_FULL))
    out["families"] = {f["arch"]: train_full_grads(dev, f["arch"],
                                                   f["layers"])
                       for f in TRAIN_GRAD_FAMILIES}
    out["full_mla"] = train_full(dev, TRAIN_FULL_MLA)
    out["full_moe_mla"] = train_full(dev, TRAIN_FULL_MOE_MLA)
    t1 = time.perf_counter()
    out["families"].update({f["arch"]: train_full_grads(
        dev, f["arch"], f["layers"], f) for f in TRAIN_GRAD_NEW})
    out["full_audio"] = train_full(dev, TRAIN_FULL_AUDIO)
    out["full_hybrid"] = train_full(dev, TRAIN_FULL_HYBRID)
    out["full_ssm"] = train_full(dev, TRAIN_FULL_SSM)
    out["smoke"] = train_smoke_families(dev)
    out["new_families_s"] = time.perf_counter() - t1
    out["phase_s"] = time.perf_counter() - t0
    print(f"  training phase: {out['phase_s']:.1f} s (the encoder-decoder, "
          f"hybrid and SSM families and the smoke twins: "
          f"{out['new_families_s']:.1f} s)")
    return out


def planted_faults(cfg) -> dict:
    """Attention functions with K5's signature that are wrong on purpose,
    for a serve phase to show that its checks would catch a wrong K5 or a
    wrong layer around it. GQA: query head h reading KV head h % K in place
    of h // (H/K), and the causal mask shifted by one key (query i also
    sees key i + 1). MLA (``cfg``'s dims): the rope key dropped from k
    (its columns of k_cat zeroed, so q·k is the nope part alone), and v
    sliced out of the joint [k_nope | v] up-projection at offset 0 in
    place of nope (v read as k_nope's first Dv columns). A sliding window
    (recurrentgemma-9b's 2048): no window at all, and the window halved.
    An encoder-decoder (whisper-tiny; the hook also stands for the
    encoder's K5, called with ``causal=False``): the encoder's attention
    made causal, and the decoder's causal mask shifted by one key (the KV
    head fault is a no-op there: K = H). An SSM has no attention to fault:
    none."""
    import torch

    from repro_torch.kernels import flash_attn as K5

    if cfg.family == "ssm":
        return {}
    if cfg.window:
        def no_window(q, k, v, scale=None, window=None):
            return K5.flash_attention_plain(q, k, v, scale)

        def half_window(q, k, v, scale=None, window=None):
            return K5.flash_attention_plain(q, k, v, scale, window // 2)

        return {"no window": no_window,
                f"window halved to {cfg.window // 2}": half_window}
    if cfg.attn_kind == "mla":
        nope, rdim = cfg.qk_nope_dim, cfg.qk_rope_dim

        def no_rope_key(q, k, v, scale=None):
            k = k.clone()
            k[..., nope:nope + rdim] = 0
            return K5.flash_attention_plain(q, k, v, scale)

        def v_offset_0(q, k, v, scale=None):
            return K5.flash_attention_plain(q, k, k[..., :v.shape[3]], scale)

        return {"rope key dropped from k": no_rope_key,
                "v sliced at offset 0": v_offset_0}

    def kv_head(q, k, v, scale=None):
        idx = torch.arange(q.shape[2], device=q.device) % k.shape[2]
        return K5.flash_attention_plain(q, k[:, :, idx], v[:, :, idx], scale)

    def next_key(q, k, v, scale=None, causal=True):
        if not causal:  # an encoder layer: left as it is
            return K5.flash_attention_plain(q, k, v, scale, causal=False)
        S, H = q.shape[1], q.shape[2]
        group = H // k.shape[2]
        qf = q.float().transpose(1, 2)
        kf = k.repeat_interleave(group, dim=2).float().transpose(1, 2)
        vf = v.repeat_interleave(group, dim=2).float().transpose(1, 2)
        logits = torch.matmul(qf, kf.transpose(-1, -2)) * (
            scale or 1.0 / math.sqrt(q.shape[3]))
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril(1)
        logits = torch.where(mask, logits, K5.NEG_INF)
        out = torch.matmul(torch.softmax(logits, dim=-1), vf)
        return out.transpose(1, 2).to(q.dtype)

    if cfg.is_encdec:
        def causal_encoder(q, k, v, scale=None, causal=True):
            return K5.flash_attention_plain(q, k, v, scale)

        return {"encoder attention made causal": causal_encoder,
                "decoder mask shifted by one key": next_key}
    return {"KV head h % K": kv_head, "mask shifted by one key": next_key}


def model_faults(cfg) -> dict:
    """Faults outside the attention hook, as context managers over the
    model: an encoder-decoder's cross-attention reading the previous
    layer's cross K/V (each decoder layer's ``xattn.wk``/``wv`` swapped for
    the layer before's while the prefill computes the cross cache; layer 0
    takes the last layer's). None for the other families."""
    import contextlib

    if not cfg.is_encdec:
        return {}

    @contextlib.contextmanager
    def previous_layer_cross_kv(model):
        ws = [(b.xattn.wk, b.xattn.wv) for b in model.layers]
        saved = [(wk.clone(), wv.clone()) for wk, wv in ws]
        try:
            for (wk, wv), (pk, pv) in zip(ws, saved[-1:] + saved[:-1]):
                wk.copy_(pk)
                wv.copy_(pv)
            yield
        finally:
            for (wk, wv), (sk, sv) in zip(ws, saved):
                wk.copy_(sk)
                wv.copy_(sv)

    return {"cross-attention reads the previous layer's cross K/V":
            previous_layer_cross_kv}


def kernel_level_fault(dev, fault, B: int, S: int, cfg) -> dict:
    """A planted attention fault held against K5 itself on random bf16
    inputs at the causal shape [B, S, H, K, hd] of ``cfg``'s prefill, with
    K5's tolerance (``K5_RTOL`` / ``K5_ATOL``): the check that would catch a
    kernel with this defect where the end-to-end logits cannot."""
    import torch

    from repro_torch.kernels import flash_attn as K5

    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((B, S, K, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((B, S, K, hd), generator=g, device=dev).bfloat16()
    want, got = K5.flash_attention(q, k, v), fault(q, k, v)
    return dict(shape=[B, S, H, K, hd, hd],
                max_abs_err=float((got.float() - want.float()).abs().max()),
                rejected=not bool(torch.allclose(got.float(), want.float(),
                                                 rtol=K5_RTOL, atol=K5_ATOL)))


def _logit_diff(a, b) -> tuple[float, float]:
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


def _recorder(store: dict, replay: dict | None = None):
    """A model ``routing=`` hook, ``(layer, probs, k)``: it appends the
    expert choices the model makes at each call of MoE layer ``layer`` to
    ``store[layer]`` (under remat the backward's rerun is the layer's
    second call, made in reverse layer order) and routes by them, or, with
    ``replay`` (another run's store), by that run's first choices of the
    layer."""
    from repro_torch.models import moe

    def routing(layer, probs, k):
        store.setdefault(layer, []).append(moe.route(probs, k))
        return store[layer][-1] if replay is None else replay[layer][0]
    return routing


def _flip_share(a: list, b: list) -> tuple[int, int]:
    """(rows, total rows) of two runs' expert choices (lists of calls, each
    a :func:`_recorder` store) whose ranked experts differ in the layers'
    first calls."""
    flips = total = 0
    for call_a, call_b in zip(a, b):
        for layer, calls in call_a.items():
            ea, eb = calls[0], call_b[layer][0]
            flips += int((ea != eb).any(dim=1).sum())
            total += ea.shape[0]
    return flips, total


def _dropped(cfg, store: dict) -> list[int]:
    """Assignments past capacity in each MoE layer of one call (a
    :func:`_recorder` store; the layers' first calls)."""
    from repro_torch.models import moe

    out = []
    for e in (calls[0] for calls in store.values()):
        C = moe.capacity(e.shape[0], cfg.top_k, cfg.n_experts,
                         cfg.capacity_factor)
        out.append(int((moe.arrival_slots(e.reshape(-1), cfg.n_experts)
                        >= C).sum()))
    return out


def serve_phase(dev, conf: dict) -> dict:
    """The LM serving path at full width (``conf``: ``SERVE``, ``SERVE_MLA``,
    ``SERVE_MOE_MLA``, ``SERVE_MOE``, ``SERVE_SSM``, ``SERVE_HYBRID``,
    ``SERVE_AUDIO`` or ``SERVE_VLM``; ``n_layers`` in it cuts the depth):
    build, generate with K5 (every launch count set to 0 just before, read
    just after: one launch an attention layer in the prefill, an encoder
    layer's with ``causal=False``, none in decode, none for an SSM), then
    the same prefill with K5's plain version and a teacher-forced decode
    fed the kernel run's tokens, and the config's planted faults; an SSM
    config also checks its chunked prefill against its recurrent form
    (``ssd_recurrent_check``). A dense, hybrid, encoder-decoder or vision
    config's checks are those end-to-end logits and greedy tokens (the
    faults of ``planted_faults`` and ``model_faults``); a vision config's
    prefill logits without its patch embeddings must also differ from
    those with them past the tolerances (the frontend is wired). An MoE
    config records every layer's expert choices,
    prints the share that differ between the kernel and the plain run and
    the end-to-end differences (with the kernel run's choices replayed
    where its own took the plain run outside the tolerances), and is
    checked layer by layer (``moe_forced_check``): its random experts'
    bf16 outputs, ~30 times the attention's in the residual stream, add
    noise in every MoE layer that 26 layers carry past the end-to-end
    tolerances, whatever K5 does. Raises on any failed check."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import (decode_step, init, init_cache,
                                    layer_kinds, prefill)
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(conf["arch"])
    label = f"{cfg.arch_id} at full width"
    if conf.get("n_layers"):
        label += f", cut to {conf['n_layers']} of {cfg.n_layers} layers"
        cfg = dataclasses.replace(cfg, n_layers=conf["n_layers"])
    is_moe = bool(cfg.n_experts)
    n_enc = cfg.enc_layers if cfg.is_encdec else 0
    n_attn = sum(k.startswith("attn") or k == "dec"
                 for k in layer_kinds(cfg)) + n_enc
    gen = torch.Generator(device=dev).manual_seed(conf["seed"])
    torch.cuda.synchronize()
    t_phase = t0 = time.perf_counter()
    model = init(cfg, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    B, S0, steps = conf["batch"], conf["prompt"], conf["gen"]
    tokens = torch.randint(0, cfg.vocab, (B, S0), generator=gen, device=dev)
    # the frontends' stubs: precomputed frame / patch embeddings
    inputs, shown = {}, ""
    if cfg.is_encdec:
        inputs["frames"] = torch.randn((B, cfg.enc_len, cfg.d_model),
                                       generator=gen, device=dev)
        shown = f", frames {list(inputs['frames'].shape)}"
    if cfg.frontend == "vision":
        inputs["images"] = torch.randn((B, cfg.n_patches, cfg.d_model),
                                       generator=gen, device=dev)
        shown = (f", the first {min(cfg.n_patches, S0)} slots patch "
                 f"embeddings {list(inputs['images'].shape)}")
    eng = Engine(cfg, model, ServeConfig(max_len=conf["max_len"]))
    print(f"serve: {label}, {n_params / 1e9:.3f} B parameters in bf16 "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated), built "
          f"in {init_s:.1f} s; generate batch {B}, prompt {S0}{shown}, "
          f"{steps} greedy tokens, max_len {conf['max_len']}")

    # an MoE run keeps each call's expert choices (prefill, then each step)
    logits, marks, routes = [], {}, []

    def timed(name, fn, *args, **kw):
        if is_moe:
            routes.append({})
            kw = dict(kw, routing=_recorder(routes[-1]))
        if name == "prefill":
            torch.cuda.synchronize()
            marks["t0"], marks["k5_0"] = time.perf_counter(), K5.launches
        out = fn(*args, **kw)
        if name == "prefill":
            torch.cuda.synchronize()
            marks["t1"], marks["k5_1"] = time.perf_counter(), K5.launches
            if is_moe:
                marks["cache"] = out[0]
        logits.append(out[1])
        return out

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out = eng.generate(tokens, steps, timed=timed, **inputs)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {k.__name__.rsplit(".", 1)[1]: k.launches
                for k in kernels.KERNELS}
    k5_routes = dict(K5.route_launches)
    k5_classes = dict(K5.class_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefill_s = marks["t1"] - marks["t0"]
    decode_s = t_end - marks["t1"]
    k5_prefill = marks["k5_1"] - marks["k5_0"]
    res = dict(config=conf, label=label, n_params=n_params, init_s=init_s,
               prefill_s=prefill_s, decode_s=decode_s,
               decode_tok_s=B * steps / decode_s,
               decode_ms_per_step=decode_s / steps * 1e3,
               peak_memory_gb=peak_gb, launches=launches,
               k5_prefill_launches=k5_prefill, k5_route_launches=k5_routes,
               k5_class_launches=k5_classes)
    print(f"  kernel run: prefill {prefill_s:.3f} s, decode {decode_s:.3f} s "
          f"({res['decode_ms_per_step']:.2f} ms/step, "
          f"{res['decode_tok_s']:.1f} tokens/s), peak memory {peak_gb:.2f} GB, "
          f"launches {launches} (flash_attn in the prefill: {k5_prefill}; "
          f"by route: {k5_routes}; by mask: {k5_classes})")
    if k5_prefill != n_attn or launches["flash_attn"] != n_attn:
        raise AssertionError(f"flash_attn launched {k5_prefill} times in the "
                             f"prefill and {launches['flash_attn']} in all, "
                             f"not {n_attn} and {n_attn}")
    if k5_routes != {"tensor_core": n_attn, "cuda_core": 0}:
        raise AssertionError(f"the bf16 prefill's flash_attn launches went "
                             f"by {k5_routes}, not all by the tensor cores")
    if k5_classes != {"causal": n_attn - n_enc, "noncausal": n_enc,
                      "query_shard": 0}:
        raise AssertionError(f"flash_attn launched {k5_classes} by mask, not "
                             f"{n_attn - n_enc} causal and {n_enc} "
                             "non-causal (the encoder's)")
    toks = out.cpu()
    assert toks.shape == (B, steps) and int(toks.min()) >= 0 and \
        int(toks.max()) < cfg.vocab
    assert len(logits) == steps + 1 and all(
        bool(torch.isfinite(lg.float()).all()) for lg in logits)
    if is_moe:
        n_moe = cfg.n_layers - cfg.first_dense_layers
        assert len(routes) == steps + 1 and all(len(r) == n_moe
                                                for r in routes)
        res["prefill_dropped_per_layer"] = _dropped(cfg, routes[0])
        print(f"  assignments dropped past capacity in the prefill, per MoE "
              f"layer (of {B * S0 * cfg.top_k}): "
              f"{res['prefill_dropped_per_layer']}; in decode: "
              f"{sum(sum(_dropped(cfg, r)) for r in routes[1:])} of "
              f"{steps * n_moe * B * cfg.top_k}")

    def routing_for(seen: list, replay: bool, call: int) -> dict:
        """``routing=`` for call ``call`` of a plain or faulty run: record
        its own choices in ``seen``, and route by them or replay the kernel
        run's."""
        if not is_moe:
            return {}
        seen.append({})
        return {"routing": _recorder(seen[-1],
                                     routes[call] if replay else None)}

    def plain_run(replay: bool) -> dict:
        """The prefill with K5's plain version, then teacher forcing along
        the kernel run's tokens: the logits' differences (and an MoE run's
        prefill caches'), the steps whose greedy tokens differ where the
        plain run's top-2 gap is clear, and its expert choices."""
        seen = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k5_before = K5.launches
        cache_p, logit_p = prefill(model, tokens,
                                   attention=K5.flash_attention_plain,
                                   **routing_for(seen, replay, 0), **inputs)
        torch.cuda.synchronize()
        run = dict(prefill_s=time.perf_counter() - t0, diffs=[], checked=0,
                   token_steps=[], seen=seen)
        if K5.launches != k5_before:
            raise AssertionError("the plain prefill launched flash_attn")
        if is_moe:
            d = [_logit_diff(a, b) for a, b in zip(marks["cache"], cache_p)]
            run["cache_diff"] = (max(x[0] for x in d), max(x[1] for x in d))
        dec = eng._merge_caches(init_cache(cfg, B, conf["max_len"],
                                           device=dev), cache_p, S0)
        del cache_p
        for i in range(steps + 1):
            run["diffs"].append(_logit_diff(logits[i], logit_p))
            if i == steps:
                break
            top2 = torch.topk(logit_p.float(), 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1] > SERVE_ATOL).cpu()
            pick_p = torch.argmax(logit_p, dim=-1).cpu()
            if not torch.equal(pick_p[clear], toks[clear, i].long()):
                run["token_steps"].append(i)
            run["checked"] += int(clear.sum())
            dec, logit_p = decode_step(model, dec, out[:, i], S0 + i,
                                       **routing_for(seen, replay, i + 1))
        run["dec"] = dec
        run["ok"] = not run["token_steps"] and all(
            dmax <= SERVE_ATOL and dmean <= SERVE_MEAN_TOL
            for dmax, dmean in run["diffs"] + [run.get("cache_diff",
                                                       (0.0, 0.0))])
        return run

    def e2e_text(run) -> str:
        d = run["diffs"]
        return (f"prefill max {d[0][0]:.4f} mean {d[0][1]:.5f}, decode "
                f"(teacher-forced) max {max(x[0] for x in d[1:]):.4f} mean "
                f"{max(x[1] for x in d[1:]):.5f}"
                + (f", prefill caches max {run['cache_diff'][0]:.4f} mean "
                   f"{run['cache_diff'][1]:.5f}" if is_moe else "")
                + f"; greedy tokens equal at {run['checked']} of "
                f"{B * steps} (sequence, step) pairs with a clear top-2 gap"
                + (f" but for steps {run['token_steps']}"
                   if run["token_steps"] else ""))

    run = plain_run(replay=False)
    plain_prefill_s = run["prefill_s"]
    print(f"  plain prefill {plain_prefill_s:.3f} s; kernel vs plain logits "
          f"end to end: {e2e_text(run)}")
    res.update(plain_prefill_s=plain_prefill_s, logit_diffs=run["diffs"],
               tokens_checked=run["checked"], tokens=toks[0].tolist())
    faults = {}
    if is_moe:
        flips, total = _flip_share(routes, run["seen"])
        pf, pt = _flip_share(routes[:1], run["seen"][:1])
        res.update(routing_flips=dict(prefill=[pf, pt], all=[flips, total]),
                   cache_diff=run["cache_diff"],
                   token_steps=run["token_steps"])
        print(f"  expert choices that differ between the kernel and the plain"
              f" run: {pf} of {pt} (token, layer) rows in the prefill "
              f"({pf / pt:.4%}), {flips} of {total} with decode "
              f"({flips / total:.4%})")
        if not run["ok"] and flips:
            del run
            run = plain_run(replay=True)
            print(f"  end to end again, replaying the kernel run's expert "
                  f"choices: {e2e_text(run)}")
            res["replayed"] = dict(logit_diffs=run["diffs"],
                                   cache_diff=run["cache_diff"],
                                   token_steps=run["token_steps"])
        forced = moe_forced_check(model, cfg, tokens, logits[0], routes[0])
        res["forced"] = forced
        faults = forced.pop("faults")
    else:
        diffs, gaps_checked = run["diffs"], run["checked"]
        for i, (dmax, dmean) in enumerate(diffs):
            if dmax > SERVE_ATOL or dmean > SERVE_MEAN_TOL:
                raise AssertionError(
                    f"logits of step {i}: kernel vs plain max {dmax:.4f}, "
                    f"mean {dmean:.5f} (tolerance {SERVE_ATOL}, "
                    f"{SERVE_MEAN_TOL})")
        if run["token_steps"]:
            raise AssertionError(f"steps {run['token_steps']}: greedy tokens "
                                 "differ where the plain run's top-2 gap is "
                                 "clear")
        if gaps_checked == 0:
            raise AssertionError("no step had a clear top-2 gap to check")
        # the same prefill and first teacher-forced decode step with each
        # planted fault: the logits checks above must reject every one
        all_faults = {name: (fault, contextlib.nullcontext)
                      for name, fault in planted_faults(cfg).items()}
        all_faults.update({name: (None, ctx)
                           for name, ctx in model_faults(cfg).items()})
        if cfg.is_encdec and cfg.n_kv_heads == cfg.n_heads:
            print(f"  planted fault, KV head h % K: a no-op at K = H = "
                  f"{cfg.n_heads} (h % K = h // (H/K) = h); not counted")
        for name, (fault, ctx) in all_faults.items():
            with ctx(model):
                cache_f, logit_f = prefill(model, tokens, attention=fault,
                                           **inputs)
                dec_f = eng._merge_caches(
                    init_cache(cfg, B, conf["max_len"], device=dev), cache_f,
                    S0)
                del cache_f
                _, logit_f1 = decode_step(model, dec_f, out[:, 0], S0)
                del dec_f
            faults[name] = dict(prefill=_logit_diff(logits[0], logit_f),
                                decode=_logit_diff(logits[1], logit_f1))
            rejected = [k for k, (dmax, dmean) in faults[name].items()
                        if dmax > SERVE_ATOL or dmean > SERVE_MEAN_TOL]
            print(f"  planted fault, {name}: kernel vs fault logits, prefill "
                  f"max {faults[name]['prefill'][0]:.4f} mean "
                  f"{faults[name]['prefill'][1]:.5f}, decode max "
                  f"{faults[name]['decode'][0]:.4f} mean "
                  f"{faults[name]['decode'][1]:.5f}; rejected by "
                  f"{', '.join(rejected) or 'nothing'}")
            if not rejected and fault is not None and cfg.is_encdec:
                # whisper's 4 decoder layers carry a one-key mask shift over
                # a 416-token prompt to the logits by less than the
                # tolerances (on the CPU at full width: 0.031 / 0.0047):
                # shown on K5's own check instead, at the decoder's shape
                kl = kernel_level_fault(dev, fault, B, S0, cfg)
                faults[name]["kernel_level"] = kl
                print(f"    not seen end to end; at kernel level (the "
                      f"decoder's K5 shape {kl['shape']}) max abs err "
                      f"{kl['max_abs_err']:.3e} against K5, rejected by K5's "
                      f"tolerance: {kl['rejected']}")
                if kl["rejected"]:
                    rejected = ["kernel level"]
            if not rejected:
                raise AssertionError(f"the planted fault '{name}' passes the "
                                     "serve phase's logits checks")
            torch.cuda.empty_cache()
    if "images" in inputs:
        # the frontend is wired: without the patch embeddings the prefill's
        # logits move past the tolerances
        _, logit_n = prefill(model, tokens)
        res["no_images_diff"] = _logit_diff(logits[0], logit_n)
        dmax, dmean = res["no_images_diff"]
        print(f"  prefill logits with vs without the patch embeddings: max "
              f"{dmax:.4f} mean {dmean:.5f}")
        if dmax <= SERVE_ATOL or dmean <= SERVE_MEAN_TOL:
            raise AssertionError("the patch embeddings do not move the "
                                 "prefill's logits past the tolerances")
    if cfg.family == "ssm":
        res["ssd_check"] = ssd_recurrent_check(model, cfg, tokens)
    dec = run.pop("dec")
    # a random-weight model may repeat one token; then the token check
    # shows little, and the logits checks must catch a wrong K5 alone
    distinct = [len(set(row)) for row in toks.tolist()]
    print(f"  distinct greedy tokens per sequence: {distinct} of {steps}")

    # where the time goes: one prefill (K5) and one decode step (the last
    # position again, the cache full) under torch.profiler
    def one_prefill():
        prefill(model, tokens, **inputs)

    def one_step():
        decode_step(model, dec, out[:, -1], S0 + steps - 1)

    for name, fn in (("prefill", one_prefill), ("decode step", one_step)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = device_busy(fn, wall)
        prof["wall_s"] = wall
        res[f"{name.replace(' ', '_')}_profile"] = prof
        print(f"  one {name}: {wall:.4f} s; {prof['busy_text']}")
        _print_top(prof)
    res.update(distinct_tokens=distinct, planted_faults=faults)
    print(f"  tokens[0]: {toks[0].tolist()}")
    del model, eng, dec, logits, run, routes, marks, inputs
    torch.cuda.empty_cache()
    res["phase_s"] = time.perf_counter() - t_phase
    print(f"  serve phase ({label}): {res['phase_s']:.1f} s")
    return res


def ssd_recurrent_check(model, cfg, tokens) -> dict:
    """An SSM model's chunked prefill against its recurrent form on the
    first ``SSD_CHECK_TOKENS`` tokens of the first prompt: end to end (the
    prefill's last-position logits and final states against as many decode
    steps from a zeroed cache; printed, see ``SSD_CHECK_TOKENS``), then
    block by block on the prefill's input to each block: its chunked
    outputs against its recurrent ones through the final norm and the head
    at every position (within ``SERVE_ATOL`` / ``SERVE_MEAN_TOL``), and its
    final state and conv window against the recurrent ones (within
    ``SSD_STATE_RTOL`` of the largest magnitude). Raises on a failed
    check."""
    import torch

    from repro_torch.models import decode_step, init_cache, prefill, ssm
    from repro_torch.models.layers import lm_head, rms_norm

    n = SSD_CHECK_TOKENS
    t = tokens[:1, :n].contiguous()
    dev = t.device
    inputs = []
    hooks = [b.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0])) for b in model.layers]
    try:
        pre, logit_p = prefill(model, t)
    finally:
        for h in hooks:
            h.remove()
    rec = init_cache(cfg, 1, n, device=dev)
    for i in range(n):
        rec, logit_r = decode_step(model, rec, t[:, i], i)
    e2e = _logit_diff(logit_p, logit_r)

    def rel(a, b) -> float:
        return float((a.float() - b.float()).abs().max()
                     / a.float().abs().max().clamp_min(1e-30))

    e2e_state = max(rel(pre.state[i], rec.state[i])
                    for i in range(cfg.n_layers))
    head = model.embed if cfg.tie_embeddings else model.head

    def lens(x):
        return lm_head(head, rms_norm(x, model.final_ln, cfg.norm_eps),
                       cfg.tie_embeddings)

    layers = []
    for i, block in enumerate(model.layers):
        x = inputs[i]
        y_p, c_p = block(x, None, None, n)
        c_r = ssm.init_ssm_cache(cfg, 1, x.dtype, dev)
        y_r = torch.cat([block(x[:, j: j + 1], None, c_r, j)[0]
                         for j in range(n)], dim=1)
        layers.append(dict(lens=_logit_diff(lens(y_p), lens(y_r)),
                           state=rel(c_p.state, c_r.state),
                           conv=rel(c_p.conv, c_r.conv)))
    worst = dict(lens=(max(x["lens"][0] for x in layers),
                       max(x["lens"][1] for x in layers)),
                 state=max(x["state"] for x in layers),
                 conv=max(x["conv"] for x in layers))
    print(f"  chunked prefill vs recurrent decode ({n} tokens of one "
          f"prompt): end to end, last-position logits max {e2e[0]:.4f} mean "
          f"{e2e[1]:.5f}, final states {e2e_state:.3e} of their largest "
          f"|state|; block by block on the prefill's inputs, logit lens at "
          f"every position max {worst['lens'][0]:.4f} mean "
          f"{worst['lens'][1]:.5f}, final state {worst['state']:.3e} and "
          f"conv window {worst['conv']:.3e} of their largest (tolerances "
          f"{SERVE_ATOL} / {SERVE_MEAN_TOL}, {SSD_STATE_RTOL})")
    if worst["lens"][0] > SERVE_ATOL or worst["lens"][1] > SERVE_MEAN_TOL \
            or worst["state"] > SSD_STATE_RTOL \
            or worst["conv"] > SSD_STATE_RTOL:
        raise AssertionError(f"chunked prefill vs recurrent decode, block "
                             f"by block: {layers}")
    del inputs, pre, rec
    torch.cuda.empty_cache()
    return dict(tokens=n, e2e_logits=e2e, e2e_state_rel=e2e_state,
                layers=layers, worst=worst)


def moe_forced_check(model, cfg, tokens, logits0, choices: dict) -> dict:
    """K5 isolated layer by layer in an MoE model: the prefill again with K5
    (each block's input recorded; its logits and expert choices must equal
    the served prefill's bit for bit), then each block alone on the kernel
    run's input to it with K5's plain version, its output against the
    kernel run's through the final norm and the head at every position
    (the logit lens; at the last block, the prefill's own logits) at
    ``SERVE_ATOL`` / ``SERVE_MEAN_TOL``. An MoE block routes by itself
    first; where that flips choices and takes a block outside the
    tolerances, every block replays the kernel run's choices, and so do
    the faults. Each planted fault runs the same way and must take some
    block outside the tolerances. Raises on any failed check."""
    import torch

    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import prefill
    from repro_torch.models.layers import lm_head, rms_norm

    inputs = []
    hooks = [b.register_forward_pre_hook(
        lambda mod, args: inputs.append(args[0])) for b in model.layers]
    hooks.append(model.layers[-1].register_forward_hook(
        lambda mod, args, out: inputs.append(out[0])))
    seen = {}
    try:
        _, lg = prefill(model, tokens, routing=_recorder(seen))
    finally:
        for h in hooks:
            h.remove()
    if not torch.equal(lg, logits0) or seen.keys() != choices.keys() or \
            not all(torch.equal(seen[i][0], choices[i][0]) for i in seen):
        raise AssertionError("a second K5 prefill differs from the served "
                             "one (logits or expert choices)")
    head = model.embed if cfg.tie_embeddings else model.head

    def lens_diff(a, b) -> tuple[float, float]:
        dmax = dsum = 0.0
        for r in range(a.shape[0]):  # one sequence at a time: [S, V]
            la, lb = (lm_head(head, rms_norm(x[r], model.final_ln,
                                             cfg.norm_eps),
                              cfg.tie_embeddings) for x in (a, b))
            d = (la.float() - lb.float()).abs()
            dmax, dsum = max(dmax, float(d.max())), dsum + float(d.sum())
            del la, lb, d
        return dmax, dsum / (a.shape[0] * a.shape[1] * head.numel()
                             / cfg.d_model)

    def forced(attention, replay: bool) -> dict:
        diffs, flips = [], 0
        for i, block in enumerate(model.layers):
            kw, got = {}, {}
            if block.moe is not None:
                kw["routing"] = functools.partial(
                    _recorder(got, choices if replay else None), i)
            o, _ = block(inputs[i], None, None, None, attention=attention,
                         **kw)
            if got and not replay:
                flips += int((got[i][0] != choices[i][0]).any(dim=1).sum())
            diffs.append(lens_diff(inputs[i + 1], o))
            del o
        worst = (max(d[0] for d in diffs), max(d[1] for d in diffs))
        return dict(layers=diffs, worst=worst, flips=flips,
                    ok=worst[0] <= SERVE_ATOL and worst[1] <= SERVE_MEAN_TOL)

    rows = tokens.numel() * (cfg.n_layers - cfg.first_dense_layers)
    plain = forced(K5.flash_attention_plain, replay=False)
    replay = False
    print(f"  layer by layer, each block on the kernel run's input with K5's "
          f"plain version, routing by itself: expert choices differ in "
          f"{plain['flips']} of {rows} (token, layer) rows; logit lens at "
          f"every position, worst block max {plain['worst'][0]:.4f} mean "
          f"{plain['worst'][1]:.5f}, last block (the prefill's logits) max "
          f"{plain['layers'][-1][0]:.4f} mean {plain['layers'][-1][1]:.5f}")
    if not plain["ok"] and plain["flips"]:
        replay = True
        plain = forced(K5.flash_attention_plain, replay=True)
        print(f"  the same, replaying the kernel run's expert choices: worst "
              f"block max {plain['worst'][0]:.4f} mean "
              f"{plain['worst'][1]:.5f}, last block max "
              f"{plain['layers'][-1][0]:.4f} mean "
              f"{plain['layers'][-1][1]:.5f}")
    if not plain["ok"]:
        raise AssertionError(f"layer by layer, kernel vs plain logit lens: "
                             f"{plain['layers']} (tolerance {SERVE_ATOL}, "
                             f"{SERVE_MEAN_TOL})")
    faults = {}
    for name, fault in planted_faults(cfg).items():
        f = forced(fault, replay)
        bad = [i for i, (dmax, dmean) in enumerate(f["layers"])
               if dmax > SERVE_ATOL or dmean > SERVE_MEAN_TOL]
        faults[name] = dict(worst=f["worst"], blocks_rejecting=bad)
        print(f"  planted fault, {name}, layer by layer: worst block max "
              f"{f['worst'][0]:.4f} mean {f['worst'][1]:.5f}; rejected by "
              f"{len(bad)} of {cfg.n_layers} blocks")
        if not bad:
            raise AssertionError(f"the planted fault '{name}' passes the "
                                 "layer-by-layer checks")
    del inputs
    torch.cuda.empty_cache()
    return dict(routing_replayed=replay, layers=plain["layers"],
                worst=plain["worst"], flips=plain["flips"], faults=faults)


def moe_card_vs_cpu(dev) -> dict:
    """One MoE layer of ``MOE_CHECK``'s config at full width (weights drawn
    on the card from a seed, copied to the CPU) on a float32 hidden input
    (a shared direction plus noise, unit variance), on the card and on the
    CPU: equal expert choices, capacity slots and
    drops, outputs within ``MOE_F32_RTOL`` of their scale, and two planted
    faults (slots in reverse arrival order; gates not renormalized) that
    these checks must reject. Then the card's bf16 ``moe_apply`` twice,
    bitwise equal. Raises on any failed check."""
    from unittest import mock

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(MOE_CHECK["arch"])
    E, k = cfg.n_experts, cfg.top_k
    gen = torch.Generator(device=dev).manual_seed(MOE_CHECK["seed"])
    layer = moe.MoE(cfg, dev)
    layer.reset_parameters(gen)
    layer_cpu = moe.MoE(cfg, "cpu")
    layer_cpu.load_state_dict(layer.state_dict())
    B, S = MOE_CHECK["batch"], MOE_CHECK["seq"]
    x = (0.5 * torch.randn((B, 1, cfg.d_model), generator=gen, device=dev)
         + torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
         ) / math.sqrt(1.25)
    C = moe.capacity(B * S, k, E, cfg.capacity_factor)

    def run(lay, xx):
        seen = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, aux = moe.moe_apply(lay, cfg, xx, routing=functools.partial(
            _recorder(seen), 0))
        slot = moe.arrival_slots(seen[0][0].reshape(-1), E)
        torch.cuda.synchronize()
        return dict(y=y.cpu(), aux=float(aux), e=seen[0][0].cpu(),
                    slot=slot.cpu(), s=time.perf_counter() - t0)

    card, cpu = run(layer, x), run(layer_cpu, x.cpu())
    scale = float(cpu["y"].abs().max())

    def failed(r) -> list[str]:
        out = []
        if not torch.equal(r["e"], cpu["e"]):
            out.append("expert choices")
        if not torch.equal(r["slot"], cpu["slot"]):
            out.append("capacity slots")
        if not torch.equal(r["slot"] >= C, cpu["slot"] >= C):
            out.append("drops")
        if float((r["y"] - cpu["y"]).abs().max()) > MOE_F32_RTOL * scale:
            out.append("outputs")
        return out

    err = float((card["y"] - cpu["y"]).abs().max())
    drops = int((cpu["slot"] >= C).sum())
    per_expert = torch.bincount(cpu["e"].reshape(-1), minlength=E)
    print(f"moe card vs CPU: {cfg.arch_id} MoE layer at full width (d "
          f"{cfg.d_model}, {E} experts of {cfg.moe_d_ff}, top-{k}, "
          f"{cfg.n_shared} shared), float32 x [{B}, {S}, {cfg.d_model}], "
          f"capacity {C}: {drops} of {B * S * k} assignments dropped, "
          f"{int((per_expert > C).sum())} experts over capacity (busiest "
          f"{int(per_expert.max())}); card {card['s'] * 1e3:.1f} ms, CPU "
          f"{cpu['s']:.2f} s; max |card - CPU| {err:.3e} (|y| up to "
          f"{scale:.1f}, tolerance {MOE_F32_RTOL} of it), aux "
          f"{card['aux']:.6f} / {cpu['aux']:.6f}")
    if drops == 0:
        raise AssertionError("the MoE check's input overflows no expert")
    bad = failed(card)
    if bad:
        raise AssertionError(f"MoE layer, card vs CPU: {', '.join(bad)} "
                             "differ")

    def reverse_slots(e_flat, n_experts, _slots=moe.arrival_slots):
        return _slots(e_flat.flip(0), n_experts).flip(0)

    faults = {}
    for name, attr, fn in (
            ("capacity slots in reverse arrival order", "arrival_slots",
             reverse_slots),
            ("gates not renormalized", "normalize_gates", lambda g: g)):
        with mock.patch.object(moe, attr, fn):
            faults[name] = failed(run(layer, x))
        print(f"  planted MoE fault, {name}: rejected by "
              f"{', '.join(faults[name]) or 'nothing'}")
        if not faults[name]:
            raise AssertionError(f"the planted MoE fault '{name}' passes "
                                 "the card-vs-CPU checks")

    xb = x.to(torch.bfloat16)
    y1, y2 = (moe.moe_apply(layer, cfg, xb)[0] for _ in range(2))
    if not torch.equal(y1, y2):
        raise AssertionError("two bf16 moe_apply runs on the card differ")
    print("  bf16 moe_apply on the card, twice: bitwise equal")
    del layer, layer_cpu, x, xb, y1, y2
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, scale=scale, dropped=drops, capacity=C,
                card_s=card["s"], cpu_s=cpu["s"], faults=faults)


def serve_small_card_vs_cpu(dev) -> None:
    """Each smoke config's weights on the card and on the CPU: the card's
    prefill (K5 on the tensor-core route for each attention layer; the MLA
    smoke configs' q·k dims 24 zero-padded to 32; recurrentgemma's window of
    32, which the 75-token prompt passes, so the hand-off goes through the
    ring and the decode step wraps it; mamba2's SSD and no K5; whisper's
    encoder through K5 with ``causal=False`` over 64 random frames;
    pixtral's 16 random patch embeddings in the first slots) and a decode
    step match the CPU's plain run (bf16 ulp flips over 2-3 layers: 0.0625,
    as the CPU tests against JAX)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import (decode_step, init, init_cache,
                                    layer_kinds, prefill)
    from repro_torch.serve import Engine, ServeConfig

    for arch in ("mistral-nemo-12b@smoke", "minicpm3-4b@smoke",
                 "phi3.5-moe-42b-a6.6b@smoke", "deepseek-v2-lite-16b@smoke",
                 "mamba2-370m@smoke", "recurrentgemma-9b@smoke",
                 "whisper-tiny@smoke", "pixtral-12b@smoke"):
        cfg = get_config(arch)
        cpu = init(cfg, torch.Generator().manual_seed(4), "cpu")
        card = init(cfg, torch.Generator().manual_seed(4), "cpu").to(dev)
        gen = torch.Generator().manual_seed(5)
        toks = torch.randint(0, cfg.vocab, (3, 75), generator=gen)
        inputs = {}
        if cfg.is_encdec:
            inputs["frames"] = torch.randn((3, cfg.enc_len, cfg.d_model),
                                           generator=gen)
        if cfg.frontend == "vision":
            inputs["images"] = torch.randn((3, cfg.n_patches, cfg.d_model),
                                           generator=gen)
        before = K5.route_launches["tensor_core"]
        runs = {}
        for name, model, d in (("cuda", card, dev), ("cpu", cpu, "cpu")):
            cache, lg = prefill(model, toks.to(d),
                                **{k: t.to(d) for k, t in inputs.items()})
            dec = Engine(cfg, model, ServeConfig(max_len=80))._merge_caches(
                init_cache(cfg, 3, 80, device=d), cache, 75)
            _, lg2 = decode_step(model, dec, toks[:, 0].to(d), 75)
            runs[name] = (lg.float().cpu(), lg2.float().cpu())
        n_attn = sum(k.startswith("attn") or k == "dec"
                     for k in layer_kinds(cfg)) + (cfg.enc_layers
                                                   if cfg.is_encdec else 0)
        assert K5.route_launches["tensor_core"] == before + n_attn
        for what, a, b in zip(("prefill", "decode"), runs["cuda"],
                              runs["cpu"]):
            dmax, dmean = _logit_diff(a, b)
            print(f"  {arch}, card vs CPU {what} logits: max {dmax:.4f} "
                  f"mean {dmean:.5f}")
            assert dmax <= 0.0625 and dmean <= 0.01


# ------------------------------------------------------------- sharded
#: the sharded program on the card: starcoder2-3b at its published width,
#: cut to 4 layers, B 2 x S 2048 (TRAIN_FULL's), remat on, over a one-rank
#: mesh (1, 1) of axes ("data", "model") under NCCL
SHARDED = dict(arch="starcoder2-3b", layers=4, batch=2, seq=2048, seed=11)
#: the host dry run of four production cells over a fake process group of
#: 256 or 512 ranks, each in a process of its own (``launch.dryrun``)
SHARDED_DRYRUN = [("mistral-nemo-12b", "train_4k", "multi"),
                  ("qwen3-14b", "prefill_32k", "single"),
                  ("deepseek-v2-lite-16b", "decode_32k", "single"),
                  ("mamba2-370m", "long_500k", "single")]


def _tree_diff(got: dict, want: dict) -> dict:
    """Leaf by leaf (a DTensor taken whole): the leaves that are not bit
    for bit equal, each with (max |diff| / max |want|, mean |diff| / mean
    |want|)."""
    import torch

    out = {}
    for k, w in want.items():
        g = got[k]
        g = g.full_tensor() if hasattr(g, "full_tensor") else g
        if not (g.shape == w.shape and bool(torch.equal(g, w))):
            d = (g.float() - w.float()).abs()
            out[k] = (float(d.max() / w.float().abs().max().clamp_min(1e-30)),
                      float(d.mean() / w.float().abs().mean().clamp_min(
                          1e-30)))
    return out


def sharded_worker(path: str) -> None:
    """The one-rank mesh on the card, in a process of its own (NCCL, world
    size 1, its own in-memory store): SHARDED's config trained one step
    through the sharded ``make_train_step`` (``constraint``, the ZeRO-1
    redistributions, K5 forward and backward reached through ``local_map``
    on the local shards) against the same step unsharded, and a prefill
    both ways; writes the comparisons and K5's launches to ``path``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.launch.specs import cell_rules
    from repro_torch.models.model import init, loss_fn, param_axes, prefill
    from repro_torch.parallel.sharding import (Mesh, axis_rules, distribute,
                                               mixed_with_dtensors)
    from repro_torch.train import (TrainConfig, TrainState, adamw_init,
                                   init_params, make_train_step,
                                   tree_zero1_specs)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    c = SHARDED
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])
    mesh = Mesh(np.full((1, 1), "cuda", dtype=object), ("data", "model"))
    gen = torch.Generator(device=dev).manual_seed(c["seed"])
    tokens = torch.randint(0, cfg.vocab, (c["batch"], c["seq"] + 1),
                           device=dev, generator=gen)
    masters = init_params(cfg, torch.Generator(device=dev).manual_seed(
        c["seed"]), dev)
    out = {}

    tcfg = TrainConfig()
    step = make_train_step(cfg, tcfg, dev)
    st, _, met = step(adamw_init({k: v.clone() for k, v in masters.items()}),
                      {"tokens": tokens}, None)
    with axis_rules(mesh, cell_rules(SHAPES["train_4k"], c["arch"])) as r:
        sstep = make_train_step(cfg, tcfg, dev)
        zs = tree_zero1_specs(param_axes(cfg, sstep.model), masters, r)

        def dist_(t, k):
            return distribute(t, None, r, spec=zs[k])

        state = TrainState(torch.zeros((), dtype=torch.int32, device=dev),
                           {k: dist_(v.clone(), k)
                            for k, v in masters.items()},
                           {k: dist_(torch.zeros_like(v), k)
                            for k, v in masters.items()},
                           {k: dist_(torch.zeros_like(v), k)
                            for k, v in masters.items()})
        batch = {"tokens": distribute(tokens, ("batch", None), r)}
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        sst, _, smet = sstep(state, batch, None)
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0
        out["k5_forward"], out["k5_backward"] = K5.launches, K5.bwd_launches
        out["loss"] = [float(met["loss"]), float(smet["loss"])]
        out["loss_equal"] = bool(torch.equal(smet["loss"].reshape(()),
                                             met["loss"].reshape(())))
        out["diff"] = {what: _tree_diff(getattr(sst, what),
                                        getattr(st, what))
                       for what in ("params", "m", "v")}
        # every leaf's gradient, on the two steps' compute copies (each
        # holds the bf16 cast of the same masters)
        names = [n for n, _ in step.model.named_parameters()]
        loss_u, _ = loss_fn(step.model, {"tokens": tokens})
        g_u = torch.autograd.grad(loss_u, list(step.model.parameters()))
        loss_s, _ = loss_fn(sstep.model, batch)
        with mixed_with_dtensors():  # the backward's plain tensors
            g_s = torch.autograd.grad(loss_s,
                                      list(sstep.model.parameters()))
        out["diff"]["grads"] = _tree_diff(dict(zip(names, g_s)),
                                          dict(zip(names, g_u)))
        out["n_leaves"] = len(names)
        del st, sst, state, g_u, g_s, step, sstep
    torch.cuda.empty_cache()

    model = init(cfg, torch.Generator(device=dev).manual_seed(c["seed"]), dev)
    _, logits = prefill(model, tokens[:, :-1])
    with axis_rules(mesh, cell_rules(SHAPES["prefill_32k"], c["arch"])) as r:
        axes = param_axes(cfg, model)
        for name, p in list(model.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = model.get_submodule(mod_name) if mod_name else model
            setattr(mod, leaf, torch.nn.Parameter(
                distribute(p.data, axes[name], r), requires_grad=False))
        kernels.reset_launches()
        _, slogits = prefill(model, distribute(tokens[:, :-1],
                                               ("batch", None), r))
        torch.cuda.synchronize()
        out["prefill_k5"] = K5.launches
        out["logits_diff"] = _tree_diff({"logits": slogits},
                                        {"logits": logits})
    dist.destroy_process_group()
    Path(path).write_text(json.dumps(out))


#: the sequence-parallel model check: SHARDED's starcoder2-3b (published
#: width, 4 layers, B 2 x S 2048) with every attention layer's queries
#: split into SEQPAR_SHARDS shards, each run through the query-shard branch
#: of ``models.attention._prefill_attention`` (K5 at its offset against all
#: 2048 keys, forward and backward), in the prefill and the loss's
#: gradient, against the same unsplit. Not two ranks on the card: NCCL
#: refuses two ranks on one device ("invalid usage"), and gloo crashed
#: (SIGSEGV) in DTensor's first all-gather of the program on a (1, 2) mesh
#: (the k/v constraint of the first attention layer), though all-gathers
#: of bf16 and float32 CUDA tensors of that size ran on its default group
SEQPAR_SHARDS = 4


def seq_parallel_check(dev) -> dict:
    """SHARDED's config, the prefill's logits and the loss's gradient of
    every leaf (``loss_fn`` with remat, as a train step takes it) with each
    attention layer run as SEQPAR_SHARDS query shards (rows o … o + S/n at
    positions o + arange(S/n) against every key, through
    ``_prefill_attention`` with ``q_offset=o``; the shards concatenated)
    against the same run unsplit (K5 on all rows). The logits and every
    leaf within TRAIN_GRAD's tolerances (each differing leaf printed), the
    loss within 5e-3; K5's launches by class counted around each run: the
    split runs launch only query-shard K5, SEQPAR_SHARDS a layer in the
    prefill, twice that forward (remat) and once backward in the
    gradient."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import layer_kinds
    from repro_torch.models.attention import _prefill_attention
    from repro_torch.models.model import init, loss_fn, prefill

    t0 = time.perf_counter()
    c = SHARDED
    cfg = dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])
    n_att = sum(k not in ("ssm", "rglru") for k in layer_kinds(cfg))
    tokens = torch.randint(0, cfg.vocab, (c["batch"], c["seq"] + 1),
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(c["seed"]))
    model = init(cfg, torch.Generator(device=dev).manual_seed(c["seed"]), dev)
    names = [n for n, _ in model.named_parameters()]

    def shards(q, k, v, scale, window=None, causal=True):
        B, S = q.shape[:2]
        n = S // SEQPAR_SHARDS
        pos = torch.arange(S, device=q.device).expand(B, S)
        return torch.cat([_prefill_attention(
            q[:, o:o + n].contiguous(), k, v, pos[:, o:o + n], cfg, causal,
            scale, None, True, kpos=pos, q_offset=o)
            for o in range(0, S, n)], dim=1)

    out, launches = {}, {}

    def counted(what, fn):
        kernels.reset_launches()
        r = fn()
        torch.cuda.synchronize()
        launches[what] = dict(forward=dict(K5.class_launches),
                              backward=dict(K5.bwd_class_launches))
        return r

    logits = {}
    with torch.no_grad():
        for what, att in (("prefill", None), ("split_prefill", shards)):
            logits[what] = counted(what, lambda: prefill(
                model, tokens[:, :-1], attention=att)[1])
    out["logits_diff"] = _tree_diff({"logits": logits["split_prefill"]},
                                    {"logits": logits["prefill"]})
    del logits
    model.requires_grad_(True)
    grads, losses = {}, {}
    for what, att in (("loss", None), ("split_loss", shards)):
        def step():
            loss, _ = loss_fn(model, {"tokens": tokens}, remat=True,
                              attention=att)
            return loss, torch.autograd.grad(loss, list(model.parameters()))
        loss, g = counted(what, step)
        losses[what] = float(loss.detach())
        grads[what] = dict(zip(names, g))
        del g
    out["grads_diff"] = _tree_diff(grads["split_loss"], grads["loss"])
    out["loss"] = [losses["loss"], losses["split_loss"]]
    out.update(launches=launches, n_leaves=len(names),
               seconds=time.perf_counter() - t0)
    del grads, model
    torch.cuda.empty_cache()
    print(f"  sequence parallel on the card: {c['arch']} at its published "
          f"width, {c['layers']} layers, B {c['batch']} x S {c['seq']}, "
          f"queries in {SEQPAR_SHARDS} shards through _prefill_attention's "
          f"query-shard branch: loss {out['loss'][1]:.6f} (unsplit "
          f"{out['loss'][0]:.6f}); {out['seconds']:.1f} s")
    for what, d in (("logits", out["logits_diff"]),
                    ("grads", out["grads_diff"])):
        worst = max(d.items(), key=lambda kv: kv[1][0], default=None)
        print(f"    {what}: " + ("bit for bit" if not d else
                                 f"{len(d)} of {out['n_leaves']} leaves "
                                 f"differ, the largest max / mean relative "
                                 f"difference {worst}"))
        for leaf, (mx, mn) in d.items():
            assert mx <= TRAIN_GRAD_ATOL_REL and mn <= TRAIN_GRAD_MEAN_REL, \
                f"sequence-parallel {what} {leaf}: {mx:.4g} / {mn:.4g}"
    assert abs(out["loss"][1] - out["loss"][0]) <= 5e-3, out["loss"]
    print(f"    K5 launches by class: {launches}")
    shard_runs = {"split_prefill": (SEQPAR_SHARDS * n_att, 0),
                  "split_loss": (2 * SEQPAR_SHARDS * n_att,
                                 SEQPAR_SHARDS * n_att)}
    for what, (fwd, bwd) in shard_runs.items():
        got = launches[what]
        assert got["forward"] == dict(causal=0, noncausal=0,
                                      query_shard=fwd), (what, got)
        assert got["backward"] == dict(causal=0, window=0, noncausal=0,
                                       query_shard=bwd), (what, got)
    return out


def _sharded_env() -> tuple[Path, Path, dict]:
    root = Path(__file__).resolve().parent
    # one intra-op thread a process: the dry runs compute nothing (fake
    # tensors), and they share the host's cores with the card's work
    return root, root / "results" / "dryrun_torch_smoke", dict(
        os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")


def start_sharded_dryruns() -> list:
    """Start SHARDED_DRYRUN's host dry runs, one process each at a lower
    priority (``nice`` 10), at the start of the sharded phase, beside its
    one-rank worker: they compute nothing on the card and take up to a
    minute or so of host time each, after every timed phase. Their stderr
    goes to a file beside their records."""
    root, out_dir, env = _sharded_env()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for cell in SHARDED_DRYRUN:
        err = out_dir / ("__".join(cell) + ".err")
        with open(err, "w") as fe:
            procs.append((cell, err, subprocess.Popen(
                ["nice", "-n", "10", sys.executable, "-m",
                 "repro_torch.launch.dryrun", "--arch", cell[0], "--shape",
                 cell[1], "--mesh", cell[2], "--out", str(out_dir)],
                env=env, cwd=root, stdout=subprocess.PIPE, stderr=fe,
                text=True)))
    return procs


def sharded_phase(dev, card: str) -> dict:
    """The sharded LM program: the sequence-parallel check
    (``seq_parallel_check``, in this process) and the one-rank mesh on the
    card (``sharded_worker`` in a subprocess) beside the host dry runs
    (``start_sharded_dryruns``; the worker's step time is taken beside
    them), then the dry runs' records; every record must be ``ok``, and
    the sharded step, its gradients and the prefill must equal the
    unsharded port's bit for bit, or stay within TRAIN_GRAD's tolerances
    with every differing leaf printed."""
    from repro_torch.configs import get_config
    from repro_torch.models import layer_kinds

    t0 = time.perf_counter()
    root, out_dir, env = _sharded_env()
    res_path = out_dir / "one_rank.json"
    dry = start_sharded_dryruns()
    try:
        # the query-shard check on the card while the dry runs start on
        # the host, then the one-rank worker
        seq_parallel = seq_parallel_check(dev)
        one, records = _sharded_results(root, env, res_path, dry)
    finally:
        for _, _, pr in dry:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    c = SHARDED
    n_att = sum(k not in ("ssm", "rglru") for k in layer_kinds(
        dataclasses.replace(get_config(c["arch"]), n_layers=c["layers"])))
    print(f"  one-rank mesh (1, 1) on {card}: {c['arch']} at its published "
          f"width, {c['layers']} layers, B {c['batch']} x S {c['seq']}: "
          f"loss {one['loss'][1]:.6f} (unsharded {one['loss'][0]:.6f}, "
          f"{'bit for bit' if one['loss_equal'] else 'differs'}); step "
          f"{one['step_s']:.3f} s (beside the dry runs); K5 launches in "
          f"the step: forward "
          f"{one['k5_forward']}, backward {one['k5_backward']} "
          f"({(one['k5_forward'] + one['k5_backward']) / n_att:.0f} a layer)"
          f"; prefill K5 launches {one['prefill_k5']}")
    for what, d in list(one["diff"].items()) + [("logits",
                                                 one["logits_diff"])]:
        print(f"    {what}: {'bit for bit' if not d else d}")
        for leaf, (mx, mn) in d.items():
            assert mx <= TRAIN_GRAD_ATOL_REL and mn <= TRAIN_GRAD_MEAN_REL, \
                f"sharded {what} {leaf}: {mx:.4g} / {mn:.4g}"
    assert abs(one["loss"][1] - one["loss"][0]) <= 5e-3, one["loss"]
    assert one["k5_forward"] == 2 * n_att and one["k5_backward"] == n_att, \
        (one["k5_forward"], one["k5_backward"])
    assert one["prefill_k5"] == n_att, one["prefill_k5"]
    bad = [k for k, r in records.items() if r.get("status") != "ok"]
    assert not bad, f"dry-run cells not ok: {bad}"
    phase_s = time.perf_counter() - t0
    print(f"  sharded phase: {phase_s:.1f} s")
    return dict(one_rank=one, dryrun=records, seq_parallel=seq_parallel,
                phase_s=phase_s)


def _sharded_results(root: Path, env: dict, res_path: Path,
                     dry: list) -> tuple[dict, dict]:
    """The one-rank worker's results and the dry runs' records (each
    printed; a record that is not ``ok`` with its stderr's tail)."""
    worker = subprocess.run([sys.executable, str(root / "chip_smoke.py"),
                             "--sharded-worker", str(res_path)], env=env,
                            cwd=root, capture_output=True, text=True,
                            timeout=600)
    if worker.returncode:
        print(worker.stdout[-4000:], worker.stderr[-8000:])
        raise RuntimeError("the one-rank sharded worker failed")
    records = {}
    for cell, err, pr in dry:
        so, _ = pr.communicate(timeout=900)
        rec = json.loads(so.strip().splitlines()[-1])
        records["__".join(cell)] = rec
        print(f"  dry run {cell}: {json.dumps(rec)}")
        if rec.get("status") != "ok":
            print(err.read_text()[-4000:])
    return json.loads(res_path.read_text()), records


def launch_counts() -> tuple[dict, dict]:
    """Every kernel's launches since the counts were set to 0, and K1's and
    K2's by shape, K3's and K4's by class."""
    from repro_torch import kernels
    from repro_torch.kernels import pairdist as K2
    from repro_torch.kernels import pareto_count as K3
    from repro_torch.kernels import round_fused as K4
    from repro_torch.kernels import systolic_eval as K1

    launches = {k.__name__.rsplit(".", 1)[1]: k.launches
                for k in kernels.KERNELS}
    return launches, dict(
        systolic_eval={f"{n}x26x{L}": c for (n, L), c in
                       sorted(K1.shape_launches.items())},
        pairdist={f"{n}x{m}x{d} {mode}": c for (n, m, d, mode), c in
                  sorted(K2.shape_launches.items())},
        pareto_count=dict(K3.shape_launches),
        round_fused=dict(K4.class_launches))


def compare_rows(what: str, a, b) -> None:
    """Assert that two soc_tuner results evaluated the same rows."""
    import numpy as np

    print(f"{what}: {a.evaluated_rows.tolist()}")
    assert np.array_equal(a.evaluated_rows, b.evaluated_rows), \
        f"{what}: the rows differ: {b.evaluated_rows.tolist()}"


def main() -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--sharded-worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.sharded_worker:  # the sharded phase's one-rank subprocess
        sharded_worker(args.sharded_worker)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels import build
    from repro_torch.random import GeneratorDraws

    # IEEE float32 products throughout, never TF32 (the port's rule).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}")

    def clock(what: str) -> None:
        """The wall time since the start, at the start of a phase (the
        script's clock: it must finish well inside its 1200 s)."""
        print(f"[clock] {what}: {time.perf_counter() - t_start:.1f} s since "
              "the start", flush=True)

    build.library()
    print(f"kernel build: {build.build_seconds():.1f} s")
    for name, info in ptxas_report(build.build_log()).items():
        print(f"  ptxas: {name}: {info}")
    print("flash_attn, bf16 route (csrc/flash_attn_tc.cu), as built:")
    k5_build = k5_build_report()
    print("round_fused (csrc/round_fused.cu) and pairdist (csrc/pairdist.cu), "
          "as built:")
    k2k4_build = k2k4_build_report()
    print("systolic_eval (csrc/systolic_eval.cu) and pareto_count "
          "(csrc/pareto_count.cu), as built:")
    k1k3_build = k1k3_build_report()

    print("kernel checks (CUDA events, median, warm L2; device = CUDA-graph "
          "replay, eager = launched from Python):")
    checks = check_kernels(dev)

    def drive(label: str, **extra):
        """One main-path run with every launch count set to 0 just before
        it; returns (result, pool, ref, flow, launches, wall seconds) and
        keeps K2's launches by shape and K4's by class in ``by_class``."""
        from repro_torch.kernels import pareto_count as K3
        from repro_torch.kernels import systolic_eval as K1

        print(f"main path ({label}): soc_tuner", json.dumps({**MAIN, **extra}))
        kernels.reset_launches()
        t0 = time.perf_counter()
        res, pool, ref, flow = run_tuner(MAIN, dev, **extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, by_class[label] = launch_counts()
        for h in res.history:
            print(f"  round {h['round']:2d} wall_s={h['wall_s']:.3f} "
                  f"evals={h['evaluations']} front={h['pareto_size']} "
                  f"adrs={h['adrs']:.5f}")
        st = res.engine_stats
        print(f"  {label}: {wall:.1f} s, final ADRS "
              f"{res.history[-1]['adrs']:.5f}, flow evaluations "
              f"{flow.evaluated} in {flow.calls} calls, rounds {st['rounds']}, "
              f"refactors {st['refactors']}, block updates "
              f"{st['block_updates']}, launches {launches}")
        print(f"  {label}: systolic_eval launches by shape (designs x 26 x "
              f"layers): {by_class[label]['systolic_eval']}; pareto_count "
              f"launches by class (small: a round's front, up to "
              f"{K3.FRONT_ROWS} rows): {by_class[label]['pareto_count']}")
        print(f"  {label}: pairdist launches by shape (n x m x d): "
              f"{by_class[label]['pairdist']}; round_fused launches by class: "
              f"{by_class[label]['round_fused']}")
        # the protocol's flow calls: the reference sweep, the ICD trials,
        # the TED init and one design a round; its fronts: the reference
        # and one a logged round (rounds 0..T) and the final one
        T = MAIN["T"]
        k1_one = K1.shape_launches.get((1, 54), 0)
        if (launches["systolic_eval"], k1_one) != (T + 3, T) or \
                K3.shape_launches != {"large": 1, "small": T + 2}:
            raise AssertionError(
                f"{label}: K1 launched {launches['systolic_eval']} times "
                f"({k1_one} at one design), K3 by class "
                f"{K3.shape_launches}; the protocol makes {T + 3} ({T}) and "
                f"1 large + {T + 2} small")
        check_result(res, pool, ref, MAIN)
        return res, pool, ref, flow, launches, wall

    by_class = {}
    res, pool, ref, flow, launches, wall = drive("exact")
    missing = [k for k in ("systolic_eval", "pairdist", "pareto_count")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the exact path: {missing}")
    breakdown = round_breakdown(res, pool, flow, MAIN, dev)

    clock('incremental main path')
    res_i, pool_i, ref_i, flow_i, launches_i, wall_i = drive(
        "incremental", incremental=True)
    missing = [k for k, n in launches_i.items()
               if n == 0 and k != "flash_attn"]
    if missing:
        raise AssertionError(
            f"kernels not launched on the incremental path: {missing}")
    if launches_i["round_fused"] < MAIN["T"]:
        raise AssertionError(f"round_fused launched {launches_i['round_fused']}"
                             f" times in {MAIN['T']} incremental rounds")
    breakdown_i = incremental_breakdown(res_i, pool_i, MAIN, dev)

    print("round_fused checks at the main path's shapes:")
    check_round_fused(dev, _pool_icd(res_i, pool_i, dev).shape[1], checks)

    # Chunking on the card: the same incremental run over 512-column chunks.
    res_c = run_tuner(MAIN, dev, incremental=True, pool_chunk=512)[0]
    print(f"incremental rows, pool_chunk=None: {res_i.evaluated_rows.tolist()}")
    compare_rows("incremental rows, pool_chunk=512 ", res_c, res_i)

    # Small input: the card's runs pick what the CPU's plain runs pick, with
    # the same draws (seeded on the CPU, handed to both).
    for label, extra in (("exact", {}), ("incremental", dict(incremental=True)),
                         ("incremental q=2", dict(incremental=True, q=2))):
        small = {}
        for d in ("cuda", "cpu"):
            small[d] = run_tuner(SMALL, d, GeneratorDraws(SMALL["seed"], "cpu"),
                                 pool_device="cpu", **extra)
            check_result(*small[d][:3], SMALL)
        r_gpu, r_cpu = small["cuda"][0], small["cpu"][0]
        compare_rows(f"small check (n_pool=64, T=6, {label}): cuda rows",
                     r_gpu, r_cpu)
        np.testing.assert_allclose(r_gpu.history[-1]["adrs"],
                                   r_cpu.history[-1]["adrs"], rtol=1e-5)

    # The fleet: six scenarios at the paper protocol (exact, incremental),
    # a fleet of one against the main runs, and the card against the CPU.
    clock('fleet phase')
    fleet = fleet_phase(dev, {"exact": breakdown, "incremental": breakdown_i},
                        card)
    # The fleet over a mesh: scenario groups, one a device (the card
    # repeated), against each other and the unsharded run.
    clock('mesh phase')
    mesh = mesh_phase(dev, fleet, card)
    fleet_of_one(dev, {"exact": res, "incremental": res_i})
    fleet_card_vs_cpu()

    # The mutable pool: K4's refresh and scores against their plain
    # versions, the proposer at full width (soc_tuner and the fleet), the
    # proposer off, resumed runs, and the card against the CPU.
    clock('proposer phases')
    print("round_fused on a mutable pool (chunk refresh, pool scores):")
    check_k4_pool_uses(dev, _pool_icd(res_i, pool_i, dev).shape[1], checks)
    proposer = proposer_phase(dev, res_i, launches_i, card)
    fleet_proposer = fleet_proposer_phase(dev, fleet, card)
    proposer_card_vs_cpu()

    # The exploration service: service_tuner (q = 1 against the main
    # incremental run; q = 4 over threads and spawn processes), the fleet
    # service, the server over the wire, and the CLI killed and resumed.
    clock('service phase')
    service = service_phase(dev, res_i, launches_i, by_class["incremental"],
                            card)

    # The paper's §IV comparison: K3 and K2 at the baselines' new shapes,
    # then the six baselines (Fig. 7(a)), card against CPU, the uncapped
    # TED, the simplified flow's gap (Fig. 4(c)) and the area breakdown of
    # the main exact run's balanced optimum (Fig. 7(b)).
    clock('baselines phase')
    print("pareto_count and pairdist at the baselines' shapes:")
    check_baseline_kernels(dev, checks)
    baselines = baselines_phase(
        dev, res, {"exact": res.history[-1]["adrs"],
                   "incremental": res_i.history[-1]["adrs"]}, card)

    clock('K5 checks')
    print("flash_attn checks (bf16; bound_ms at the bf16 tensor-core peak):")
    check_flash_attn(dev, checks)
    print("flash_attn with causal=False (both routes; bound_ms at the "
          "route's peak, all S² pairs):")
    check_flash_attn_noncausal(dev, checks)
    clock('serve phases')
    serve = serve_phase(dev, SERVE)
    serve_mla = serve_phase(dev, SERVE_MLA)
    serve_moe_mla = serve_phase(dev, SERVE_MOE_MLA)
    serve_moe = serve_phase(dev, SERVE_MOE)
    serve_ssm = serve_phase(dev, SERVE_SSM)
    serve_hybrid = serve_phase(dev, SERVE_HYBRID)
    serve_audio = serve_phase(dev, SERVE_AUDIO)
    serve_vlm = serve_phase(dev, SERVE_VLM)
    clock('card-vs-CPU checks')
    moe_check = moe_card_vs_cpu(dev)
    serve_small_card_vs_cpu(dev)

    # Training: K5's backward and the forward's row statistic against their
    # plain versions, then qwen3-100m and starcoder2-3b trained on the card.
    clock('K5 backward checks')
    print("flash_attn backward (csrc/flash_attn_bwd.cu) and the forward's "
          "row statistic (bound_ms at the bf16 tensor-core peak):")
    k5_bwd_build = k5_bwd_build_report()
    check_flash_attn_backward(dev, checks)
    clock('K5 query-shard checks')
    print("flash_attn on query shards (sequence parallelism; bound_ms over "
          "the shard's pairs at the bf16 tensor-core peak):")
    check_flash_attn_query_shards(dev, checks)
    clock('training phase')
    print("training:")
    training = train_phase(dev)
    clock('sharded phase')
    print("the sharded program (one-rank mesh on the card; dry run of four "
          "production cells on the host beside it):")
    sharded = sharded_phase(dev, card)

    clock('the end of the phases')
    src = "src/repro_torch/csrc/"
    meta = {
        "systolic_eval": ("systolic_eval.cu",
                          "src/repro/kernels/systolic_eval/kernel.py:33",
                          launches),
        # the multi-workload entry: its launches in the exact fleet run
        "systolic_eval_multi": (
            "systolic_eval.cu", "src/repro/kernels/systolic_eval/kernel.py:33",
            {"systolic_eval_multi":
             sum(fleet["exact"]["systolic_eval_multi"].values())}),
        "pairdist": ("pairdist.cu", "src/repro/kernels/pairdist/kernel.py:36",
                     launches),
        "pareto_count": ("pareto_count.cu",
                         "src/repro/kernels/pareto_count/kernel.py:34",
                         launches),
        "round_fused": ("round_fused.cu",
                        "src/repro/kernels/round_fused/kernel.py:142",
                        launches_i),
        # the fleet over a mesh of 2 groups: K1's multi-workload entry, K2,
        # K3 and K4 as launched there (held against their plain versions
        # at the checks named last)
        "systolic_eval_multi_mesh": (
            "systolic_eval.cu", "src/repro/kernels/systolic_eval/kernel.py:33",
            {"systolic_eval_multi_mesh": mesh["2"]["systolic_eval_multi"]},
            "systolic_eval_multi"),
        "pairdist_mesh": ("pairdist.cu",
                          "src/repro/kernels/pairdist/kernel.py:36",
                          {"pairdist_mesh": mesh["2"]["launches"]["pairdist"]},
                          "pairdist"),
        "pareto_count_mesh": (
            "pareto_count.cu", "src/repro/kernels/pareto_count/kernel.py:34",
            {"pareto_count_mesh": mesh["2"]["launches"]["pareto_count"]},
            "pareto_count"),
        "round_fused_mesh": (
            "round_fused.cu", "src/repro/kernels/round_fused/kernel.py:142",
            {"round_fused_mesh": mesh["2"]["launches"]["round_fused"]},
            "round_fused"),
        # K4's pool uses: their launches in the proposer run
        "round_fused_refresh": (
            "round_fused.cu", "src/repro/kernels/round_fused/kernel.py:142",
            {"round_fused_refresh":
             proposer["round_fused_by_class"]["refresh"]}),
        "round_fused_scores": (
            "round_fused.cu", "src/repro/kernels/round_fused/kernel.py:142",
            {"round_fused_scores":
             proposer["round_fused_by_class"]["scores"]}),
        # the baselines phase: K3 in microal's run (its fronts and EHVI
        # hypervolumes), K2 in microal's run (TED and the GP), K2 in the
        # uncapped TED
        "pareto_count_ehvi": (
            "pareto_count.cu", "src/repro/kernels/pareto_count/kernel.py:34",
            {"pareto_count_ehvi": baselines["fig7a"]["microal"]["launches"][
                "pareto_count"]}),
        "pairdist_microal": (
            "pairdist.cu", "src/repro/kernels/pairdist/kernel.py:36",
            {"pairdist_microal": baselines["fig7a"]["microal"]["launches"][
                "pairdist"]}),
        "pairdist_uncapped": (
            "pairdist.cu", "src/repro/kernels/pairdist/kernel.py:36",
            {"pairdist_uncapped": baselines["uncapped_ted"]["launches"]}),
        "flash_attn": ("flash_attn_tc.cu",
                       "src/repro/kernels/flash_attn/kernel.py:61",
                       serve["launches"]),
        # K5 at MLA's head dims (96, 64): its launches in minicpm3-4b's run
        "flash_attn_mla": ("flash_attn_tc.cu",
                           "src/repro/kernels/flash_attn/kernel.py:61",
                           {"flash_attn_mla":
                            serve_mla["launches"]["flash_attn"]}),
        # K5 at (192, 128): its launches in deepseek-v2-lite-16b's run
        "flash_attn_mla_192": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_mla_192": serve_moe_mla["launches"]["flash_attn"]}),
        # K5 at (256, 256) with a window of 2048: its launches in
        # recurrentgemma-9b's run
        "flash_attn_window": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_window": serve_hybrid["launches"]["flash_attn"]}),
        # K5 with causal=False at (64, 64): its launches in whisper-tiny's
        # run (the encoder's), and the causal (64, 64) ones (the decoder's)
        "flash_attn_noncausal": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_noncausal":
             serve_audio["k5_class_launches"]["noncausal"]}),
        "flash_attn_whisper_dec": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_whisper_dec":
             serve_audio["k5_class_launches"]["causal"]}),
        # training: K5's forward with its row statistic and its backward
        # (the TPU kernel has no backward: the reference differentiates
        # _sdpa; "replaces" names the kernel whose gradient it is), in
        # starcoder2-3b's timed steps (128) and qwen3-100m's run (64)
        "flash_attn_train": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_train":
             training["full"]["launches"]["forward_total"]}),
        "flash_attn_bwd": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd":
             training["full"]["launches"]["backward_total"]}),
        "flash_attn_train_64": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_train_64": training["small"]["launches"]["forward"]}),
        "flash_attn_bwd_64": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_64": training["small"]["launches"]["backward"]}),
        # MLA's training: minicpm3-4b's timed steps at (96, 64),
        # deepseek-v2-lite-16b's at (192, 128), the MLA smoke configs
        # through launch/train.py at (32, 16)
        "flash_attn_train_mla": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_train_mla":
             training["full_mla"]["launches"]["forward_total"]}),
        "flash_attn_bwd_mla": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_mla":
             training["full_mla"]["launches"]["backward_total"]}),
        "flash_attn_train_mla_192": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_train_mla_192":
             training["full_moe_mla"]["launches"]["forward_total"]}),
        "flash_attn_bwd_mla_192": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_mla_192":
             training["full_moe_mla"]["launches"]["backward_total"]}),
        "flash_attn_train_mla_32": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_train_mla_32": sum(
                training["smoke"][a]["launches"]["forward"]
                for a in TRAIN_SMOKE_MLA)}),
        "flash_attn_bwd_mla_32": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_mla_32": sum(
                training["smoke"][a]["launches"]["backward"]
                for a in TRAIN_SMOKE_MLA)}),
        # the encoder-decoder's, the hybrid's and the smoke twins' training:
        # whisper-tiny's encoder without the causal mask (64, 64) in its
        # timed steps, recurrentgemma-9b's windowed (256, 256) in its timed
        # steps, the smoke twins' (16, 16) through launch/train.py (and
        # whisper's through make_train_step)
        "flash_attn_train_noncausal": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_train_noncausal": training["full_audio"]["launches"][
                "forward_by_mask"]["noncausal"]}),
        "flash_attn_bwd_noncausal": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_noncausal": training["full_audio"]["launches"][
                "backward_by_mask"]["noncausal"]}),
        "flash_attn_train_window": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_train_window":
             training["full_hybrid"]["launches"]["forward_total"]}),
        "flash_attn_bwd_window": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_window": training["full_hybrid"]["launches"][
                "backward_by_mask"]["window"]}),
        "flash_attn_train_16": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_train_16": sum(
                r["launches"]["forward"] for a, r in training["smoke"].items()
                if a not in TRAIN_SMOKE_MLA)}),
        "flash_attn_bwd_16": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_16": sum(
                r["launches"]["backward"] for a, r in training["smoke"].items()
                if a not in TRAIN_SMOKE_MLA)}),
        # the sharded program on the one-rank mesh: K5 forward (the step's,
        # remat's and the prefill's) and backward through local_map, at
        # starcoder2-3b's training shape (held against their plain
        # versions at the checks named last)
        "flash_attn_sharded": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_sharded": sharded["one_rank"]["k5_forward"]
             + sharded["one_rank"]["prefill_k5"]}, "flash_attn_train"),
        "flash_attn_bwd_sharded": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_sharded": sharded["one_rank"]["k5_backward"]},
            "flash_attn_bwd"),
        # K5 with a query-row offset: its query-shard launches in the
        # sequence-parallel check (the split prefill and the split loss's
        # gradient)
        "flash_attn_qshard": (
            "flash_attn_tc.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_qshard": sum(
                c["forward"]["query_shard"] for c in
                sharded["seq_parallel"]["launches"].values())}),
        "flash_attn_bwd_qshard": (
            "flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:61",
            {"flash_attn_bwd_qshard": sum(
                c["backward"]["query_shard"] for c in
                sharded["seq_parallel"]["launches"].values())}),
    }
    entries = []
    for name, (cu, replaces, counts, *check) in meta.items():
        key = check[0] if check else name  # the check a mesh entry reads
        head = checks[key][0]
        errs = [c["max_abs_err"] for k in checks  # pairdist_rbf with pairdist
                if k == key or k.startswith(key + "_") and k not in meta
                for c in checks[k]]
        entries.append(dict(
            name=name, route="cuda", source=src + cu, replaces=replaces,
            launches=counts[name], max_abs_err=max(errs), ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            shape=head["shape"]))
        for key in ("bound_f32_ms", "k5_route", "library"):
            if key in head:
                entries[-1][key] = head[key]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            card=card, torch=torch.__version__, cuda=torch.version.cuda,
            build_s=build.build_seconds(), k5_build=k5_build,
            k2k4_build=k2k4_build, k1k3_build=k1k3_build, checks=checks,
            kernels=entries,
            main=dict(config=MAIN, wall_s=wall, history=res.history,
                      flow_evaluated=flow.evaluated, flow_calls=flow.calls,
                      launches=launches, launches_by_class=by_class["exact"],
                      round_breakdown=breakdown),
            incremental=dict(config={**MAIN, "incremental": True},
                             wall_s=wall_i, history=res_i.history,
                             engine_stats=res_i.engine_stats,
                             flow_evaluated=flow_i.evaluated,
                             flow_calls=flow_i.calls, launches=launches_i,
                             launches_by_class=by_class["incremental"],
                             round_breakdown=breakdown_i),
            fleet=fleet, mesh=mesh, proposer=proposer,
            fleet_proposer=fleet_proposer,
            service=service, baselines=baselines, serve=serve,
            serve_mla=serve_mla, serve_moe_mla=serve_moe_mla,
            serve_moe=serve_moe, serve_ssm=serve_ssm,
            serve_hybrid=serve_hybrid, serve_audio=serve_audio,
            serve_vlm=serve_vlm, moe_check=moe_check, training=training,
            sharded=sharded,
            k5_bwd_build=k5_bwd_build,
            wall_s=time.perf_counter() - t_start),
            indent=1))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
