"""Launch plans of the redesigned kernels, on the CPU: K4 ``round_fused``
(``kernels/round_fused.py::launch_plan``), K2 ``pairdist``
(``kernels/pairdist.py::launch_plan``), K1 ``systolic_eval`` and K3
``pareto_count``. Every shape of the grid gets a plan, none raises, and no
plan asks for more shared memory than a Hopper block may opt into (232,448
bytes)."""
import itertools

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers that share the
# cores, and torch's per-process thread pools oversubscribe them
torch.set_num_threads(1)

from repro_torch.kernels import pairdist as K2
from repro_torch.kernels import pareto_count as K3
from repro_torch.kernels import round_fused as K4
from repro_torch.kernels import systolic_eval as K1

HOPPER_BLOCK_SMEM = 232_448
PS = (1, 8, 72, 256, 1024)
DS = (1, 26, 64, 128)
MS = (1, 3, 8)


def _s0_classes(P):
    """Refactor, block update (the bucket floor below P) and score only."""
    return sorted({0, max(0, P - 8), P - 1, P} - {-1})


@pytest.mark.parametrize("P", PS)
def test_round_fused_plans_fit_a_hopper_block(P):
    lanes = K4.LANES
    for d, m in itertools.product(DS, MS):
        for s0 in _s0_classes(P):
            plan = K4.launch_plan(1, 2500, d, m, P, s0)
            assert 0 < plan["smem_bytes"] <= HOPPER_BLOCK_SMEM, plan
            assert plan["smem_bytes"] <= K4.SMEM_LIMIT
            assert plan["smem_bytes"] == 4 * K4._smem_floats(
                d, m, P, P - min(s0, P), *(plan[k] for k in
                                           ("ct", "w", "R", "lmode", "xs",
                                            "pv")))
            assert 32 <= plan["threads"] <= K4.MAX_THREADS
            assert plan["threads"] == plan["w"] * plan["ct"] * lanes
            assert plan["threads"] % 32 == 0
            assert 1 <= plan["w"] <= m
            assert plan["R"] % lanes == 0 and lanes <= plan["R"] <= 32
            assert plan["lmode"] in (K4.RESIDENT, K4.RING, K4.DEVICE)
            assert plan["lmode"] != K4.RESIDENT or plan["xs"] == 1
            assert 0 <= plan["pv"] <= P


@pytest.mark.parametrize("P", PS)
def test_round_fused_keeps_v_on_chip_wherever_it_fits(P):
    """Up to P = 1024 every class keeps all P rows of the V tile in shared
    memory; only where the whole L block does not fit does L stream."""
    for d, m in itertools.product(DS, MS):
        for s0 in _s0_classes(P):
            plan = K4.launch_plan(1, 2500, d, m, P, s0)
            assert plan["pv"] == P
            if plan["lmode"] != K4.RESIDENT:
                assert 4 * K4._smem_floats(
                    d, m, P, P - s0, plan["ct"], plan["w"], plan["R"],
                    K4.RESIDENT, 1, P) > K4.SMEM_LIMIT


def test_round_fused_main_path_plan():
    """The main path's refactor (C = 2500, d = 26, m = 3, P = 72): L and the
    scaled rows resident, all three objectives in one wave, 32-column tiles
    of 768 threads (79 of them, one a block)."""
    plan = K4.launch_plan(1, 2500, 26, 3, 72, 0)
    assert (plan["lmode"], plan["w"], plan["pv"], plan["xs"]) == \
        (K4.RESIDENT, 3, 72, 1)
    assert (plan["ct"], plan["threads"], plan["tiles"]) == (32, 768, 79)


def test_round_fused_plans_streams_what_does_not_fit():
    """P = 512 at s0 = 0 cannot hold L resident (1 MB per objective): it
    takes the ring; a huge P keeps part of V in device memory; a huge d
    divides inline. None of them raises."""
    assert K4.launch_plan(1, 37, 11, 3, 512, 0)["lmode"] == K4.RING
    assert K4.launch_plan(1, 37, 11, 3, 512, 504)["lmode"] in (K4.RESIDENT,
                                                               K4.RING)
    big = K4.launch_plan(1, 100, 26, 3, 60_000, 0)
    assert big["lmode"] == K4.DEVICE and big["pv"] < 60_000
    assert big["smem_bytes"] <= K4.SMEM_LIMIT
    wide = K4.launch_plan(1, 100, 20_000, 3, 72, 0)
    assert wide["xs"] == 0 and wide["smem_bytes"] <= K4.SMEM_LIMIT


def test_round_fused_launch_classes():
    assert K4.launch_class(0, 72) == "refactor"
    assert K4.launch_class(64, 72) == "block_update"
    assert K4.launch_class(72, 72) == K4.launch_class(99, 72) == "score_only"


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (72, 72, 26), (72, 2500, 26),
                                   (72, 512, 26), (512, 512, 26),
                                   (64, 2500, 26), (2500, 2500, 26),
                                   (200, 100, 40), (33, 70, 128)])
def test_pairdist_plans(n, m, d):
    plan = K2.launch_plan(n, m, d)
    assert plan["tm"] in (8, 4, 2, 1)
    assert plan["tile"] == (16 * plan["tm"], 64)
    assert plan["threads"] == 256
    assert plan["grid"] == (-(-m // 64), -(-n // (16 * plan["tm"])))
    assert plan["smem_bytes"] <= 48 * 1024  # static shared memory
    assert plan["chunk"] == min(d, 32)
    if plan["tm"] < 8:  # a taller tile would have had too few blocks
        tm = 2 * plan["tm"]
        assert -(-m // 64) * -(-n // (16 * tm)) < K2.TARGET_BLOCKS[tm]


def test_pairdist_small_gp_shapes_get_more_blocks():
    """The GP's 72 x 72 block gets 10 blocks (4 with 64 x 64 tiles) and
    512 x 512 gets 128 (64); TED's 2500 x 2500 takes 128-row tiles."""
    assert K2.launch_plan(72, 72, 26)["blocks"] == 10
    assert K2.launch_plan(512, 512, 26)["blocks"] == 128
    assert K2.launch_plan(64, 2500, 26)["tm"] == 2
    assert K2.launch_plan(2500, 2500, 26)["tm"] == 8


@pytest.mark.parametrize("n", [1, 30, 2500, 100_000])
@pytest.mark.parametrize("L", [1, 54, 559, K1.MAX_LAYERS])
def test_systolic_eval_plans_fit_a_hopper_block(n, L):
    plan = K1.launch_plan(n, L)
    g, kr = plan["g"], plan["kr"]
    assert g == 1 << plan["g_log2"] and 4 <= g <= 32
    few = min(32, max(4, K1._pow2(L)))  # as many lanes as layers
    if g != few:  # many designs: the fewest lanes with 4 layers a lane
        assert n >= K1.SMS * K1.THROUGHPUT_WARPS * (32 // g)
        assert kr == 4 and (g == 4 or -(-L // (g // 2)) > 4)
    assert kr in (0,) + K1.REGISTER_LAYERS
    assert kr == 0 or -(-L // g) <= kr
    if kr == 0:
        assert -(-L // g) > max(K1.REGISTER_LAYERS)
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 128
    assert plan["designs_per_block"] == plan["threads"] // g
    assert plan["blocks"] * plan["designs_per_block"] >= n
    assert (plan["blocks"] - 1) * plan["designs_per_block"] < n
    assert plan["stride"] % 2 == 1 and plan["stride"] >= L
    arrays = 3 if kr else 5
    assert plan["smem_bytes"] == 4 * (
        5 * L + plan["designs_per_block"] * arrays * plan["stride"])
    assert plan["smem_bytes"] <= HOPPER_BLOCK_SMEM


def test_systolic_eval_main_path_plans():
    """resnet50's 54 layers: one design, the TED init's 20 and the ICD
    trials' 30 take a warp a design (2 layers a lane in registers) and a
    warp a block (a block an SM); 2500 designs take 16 lanes a design (4
    layers a lane), 4 warps a block (313 blocks)."""
    for n, g, kr, threads, blocks in ((1, 32, 2, 32, 1), (20, 32, 2, 32, 20),
                                      (30, 32, 2, 32, 30),
                                      (2500, 16, 4, 128, 313)):
        plan = K1.launch_plan(n, 54)
        assert (plan["g"], plan["kr"]) == (g, kr)
        assert (plan["threads"], plan["blocks"]) == (threads, blocks)
    assert K1.launch_plan(2500, 559)["kr"] == 0


@pytest.mark.parametrize("g", [4, 8, 16, 32])
@pytest.mark.parametrize("L", [1, 54, 559, K1.MAX_LAYERS])
def test_systolic_eval_every_group_width_has_a_plan(g, L):
    """A forced group width gets a plan that fits, or raises where a warp
    of designs (32 / g of them) cannot hold its per-layer arrays."""
    need = 4 * (5 * L + (32 // g) * 5 * (L | 1))
    if -(-L // g) > 4 and need > HOPPER_BLOCK_SMEM:
        with pytest.raises(ValueError, match="shared memory"):
            K1.launch_plan(2500, L, g)
        return
    plan = K1.launch_plan(2500, L, g)
    assert plan["g"] == g and plan["smem_bytes"] <= HOPPER_BLOCK_SMEM
    assert plan["kr"] == 0 or -(-L // g) <= plan["kr"]
    with pytest.raises(ValueError, match="lanes"):
        K1.launch_plan(2500, L, 64)


@pytest.mark.parametrize("W,n,L", [(3, 2, 54), (3, 40, 54), (3, 60, 54),
                                   (3, 2500, 54), (3, 2500, 559),
                                   (2, 1, 559), (6, 2500, 54)])
def test_systolic_eval_multi_plans_fit_a_hopper_block(W, n, L):
    """K1's multi-workload plan: its grid is (a workload's design tiles,
    W); the shared bytes hold the Lmax-row table and each design's arrays."""
    plan = K1.launch_plan(n, L, workloads=W)
    assert plan["grid"] == (plan["blocks"], W)
    assert plan["blocks"] * plan["designs_per_block"] >= n
    assert (plan["blocks"] - 1) * plan["designs_per_block"] < n
    arrays = 3 if plan["kr"] else 5
    assert plan["smem_bytes"] == 4 * (
        5 * L + plan["designs_per_block"] * arrays * plan["stride"])
    assert plan["smem_bytes"] <= HOPPER_BLOCK_SMEM
    assert plan["kr"] == 0 or -(-L // plan["g"]) <= plan["kr"]
    # the W·n designs decide the lanes: W workloads of n designs get the
    # plan of W·n designs, with a workload's tiles a grid row
    flat = K1.launch_plan(W * n, L)
    assert (plan["g"], plan["kr"]) == (flat["g"], flat["kr"])


def test_systolic_eval_multi_plans_at_the_fleets_flushes():
    """The fleet's fused flushes over resnet50, mobilenet and transformer
    (Lmax 54): a round's picks (3 x 2) and the TED init (3 x 40) take a
    warp a design, a warp a block; the 3 x 2500 timing shape 16 lanes a
    design, 4 warps a block. At Lmax 559 (kr 0) the arrays sit in shared
    memory: 55,900 bytes."""
    for n, g, kr, threads, grid, smem in (
            (2, 32, 2, 32, (2, 3), 4 * (270 + 3 * 55)),
            (40, 32, 2, 32, (40, 3), 4 * (270 + 3 * 55)),
            (2500, 16, 4, 128, (313, 3), 4 * (270 + 8 * 3 * 55))):
        plan = K1.launch_plan(n, 54, workloads=3)
        assert (plan["g"], plan["kr"], plan["threads"]) == (g, kr, threads)
        assert (plan["grid"], plan["smem_bytes"]) == (grid, smem)
    plan = K1.launch_plan(2500, 559, workloads=3)
    assert (plan["kr"], plan["threads"], plan["grid"]) == (0, 128, (625, 3))
    assert plan["smem_bytes"] == 4 * (5 * 559 + 4 * 5 * 559) == 55_900
    # one workload: the single-workload plan, grid (blocks, 1)
    assert K1.launch_plan(30, 54, workloads=1) == K1.launch_plan(30, 54)


@pytest.mark.parametrize("n", [1, 64, 70, 2500, 20_000])
@pytest.mark.parametrize("m", range(1, 9))
def test_pareto_count_plans_fit_a_hopper_block(n, m):
    plan = K3.launch_plan(n, m)
    r, a, s = plan["rows_per_thread"], plan["row_threads"], plan["splits"]
    assert r in (2, 4) and plan["rows_per_block"] <= r * a
    assert -(-plan["rows_per_block"] // r) <= 32  # row threads with rows
    assert s == 1 << plan["s_log2"]
    assert plan["threads"] == a * s <= 1024 and plan["threads"] % 32 == 0
    assert plan["blocks"] == -(-n // plan["rows_per_block"])
    assert plan["pad"] == (4 if m <= 4 else 8)
    assert 1 <= plan["tile_rows"] <= n
    assert plan["tiles"] * plan["tile_rows"] >= n
    assert plan["smem_bytes"] == 4 * (plan["pad"] * plan["tile_rows"]
                                      + -(-s // 32) * r * a)
    assert plan["smem_bytes"] <= HOPPER_BLOCK_SMEM
    if n <= K3.FRONT_ROWS:
        assert plan["rows_per_block"] == min(n, K3.SMALL_ROWS)
    if n >= 2500:
        assert plan["blocks"] >= 132


def test_pareto_count_plans_for_round_fronts_and_the_reference_front():
    """A round's front (50-70 rows): blocks of 16 rows, 128 threads (8 row
    threads of 2 rows, 16 splits); the reference front (2500 x 3): one block
    of 19 rows on each of the 132 SMs (5 row threads of 4 rows, 128
    splits)."""
    for n, blocks in ((50, 4), (64, 4), (70, 5)):
        plan = K3.launch_plan(n, 3)
        assert (plan["blocks"], plan["threads"]) == (blocks, 128)
    plan = K3.launch_plan(2500, 3)
    assert (plan["blocks"], plan["rows_per_block"], plan["threads"]) == \
        (132, 19, 640)
    assert K3.launch_plan(2500, 3, per_sm=2)["rows_per_block"] == 16
    assert K3.launch_plan(129, 3)["rows_per_block"] == K3.SMALL_ROWS
    assert K3.launch_plan(20_000, 3)["blocks"] >= 132
