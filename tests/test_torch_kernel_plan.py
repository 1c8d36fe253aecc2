"""Launch plans of the redesigned kernels, on the CPU: K4 ``round_fused``
(``kernels/round_fused.py::launch_plan``) and K2 ``pairdist``
(``kernels/pairdist.py::launch_plan``). Every shape of the grid gets a plan,
none raises, and no plan asks for more shared memory than a Hopper block may
opt into (232,448 bytes)."""
import itertools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import pairdist as K2
from repro_torch.kernels import round_fused as K4

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
