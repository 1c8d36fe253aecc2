"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device. Run them on a GPU
host with ``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py`` (``--noconftest``: the shared conftest imports
jax, which this file does not need).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core import make_space
from repro_torch.kernels import pairdist as K2
from repro_torch.kernels import pareto_count as K3
from repro_torch.kernels import round_fused as K4
from repro_torch.kernels import systolic_eval as K1
from repro_torch.soc.workloads import get_workload

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("workload", ["resnet50", "mobilenet", "transformer"])
@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_systolic_eval_matches_plain(dev, workload, n):
    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(n), n).numpy()
    vals = torch.as_tensor(space.values(idx), dtype=torch.float32, device=dev)
    layers = torch.as_tensor(get_workload(workload), dtype=torch.float32,
                             device=dev)
    before = K1.launches
    got = K1.soc_metrics(vals, layers)
    assert K1.launches == before + 1
    # float32 sums over the layers in another order, powf/log2f ulps
    torch.testing.assert_close(got, K1.soc_metrics_plain(vals, layers),
                               rtol=2e-5, atol=0)


def _long_table(n_layers):
    """A layer table of ``n_layers`` rows: minicpm3-4b's 559 rows
    (``from_arch_config``), repeated."""
    return np.resize(get_workload("minicpm3-4b"), (n_layers, 5))


@pytest.mark.parametrize("L", [559, K1.MAX_LAYERS])
@pytest.mark.parametrize("n", [1, 31, 2500])
def test_systolic_eval_long_tables_match_plain(dev, L, n):
    """The redesigned K1 with its per-layer values in shared memory (more
    than 4 layers a lane): 559 rows (minicpm3-4b) and the largest table."""
    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(n + L), n).numpy()
    vals = torch.as_tensor(space.values(idx), dtype=torch.float32, device=dev)
    layers = torch.as_tensor(_long_table(L), dtype=torch.float32, device=dev)
    assert K1.launch_plan(n, L)["kr"] == 0
    before = K1.launches
    got = K1.soc_metrics(vals, layers)
    assert K1.launches == before + 1
    assert K1.shape_launches[(n, L)] >= 1
    # 559 rows: the tolerance of test_systolic_eval_matches_plain. The
    # largest table: the kernel adds the L positive terms of each sum one
    # after another (the first port's order, kept bit for bit), an error of
    # up to (L - 1) * 2^-24 of the sum where the plain version's tree order
    # stays near 2^-24; power is a ratio of two such sums, so 2 * L * 2^-24
    rtol = 2e-5 if L <= 559 else 2 * L * 2.0 ** -24
    torch.testing.assert_close(got, K1.soc_metrics_plain(vals, layers),
                               rtol=rtol, atol=0)


@pytest.mark.parametrize("L", [1, 3, 5, 17, 33, 128, 129])
def test_systolic_eval_group_widths_match_plain(dev, L):
    """Every group width (4 to 32 lanes a design) and register count (1, 2,
    4 layers a lane, or shared memory), with designs past the last in a
    block's last group."""
    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(L), 77).numpy()
    vals = torch.as_tensor(space.values(idx), dtype=torch.float32, device=dev)
    layers = torch.as_tensor(_long_table(L), dtype=torch.float32, device=dev)
    got = K1.soc_metrics(vals, layers)
    torch.testing.assert_close(got, K1.soc_metrics_plain(vals, layers),
                               rtol=2e-5, atol=0)
    # one design alone gets what it gets in a batch, bit for bit
    one = K1.soc_metrics(vals[5:6].contiguous(), layers)
    assert torch.equal(one, got[5:6])


@pytest.mark.parametrize("L", [54, 559])
def test_systolic_eval_output_does_not_depend_on_the_group_width(dev, L):
    """Every sum runs over layers 0..L-1 in order whatever the lanes a
    design: the outputs at 4, 8, 16 and 32 lanes are bitwise equal."""
    from repro_torch.kernels import build

    space = make_space()
    n = 300
    idx = space.sample(torch.Generator().manual_seed(L), n).numpy()
    vals = torch.as_tensor(space.values(idx), dtype=torch.float32, device=dev)
    layers = torch.as_tensor(_long_table(L), dtype=torch.float32, device=dev)
    outs = []
    for g in (4, 8, 16, 32):
        p = K1.launch_plan(n, L, g)
        o = torch.empty((n, 3), device=dev)
        build.check(build.library().systolic_eval_launch(
            vals.data_ptr(), layers.data_ptr(), o.data_ptr(), n, L,
            p["g_log2"], p["kr"], p["threads"], p["stride"], p["smem_bytes"],
            build.stream_ptr(vals)), "systolic_eval")
        outs.append(o)
    torch.cuda.synchronize()
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(outs[0], K1.soc_metrics(vals, layers))


FLEET_WORKLOADS = ("resnet50", "mobilenet", "transformer")


def _multi_inputs(dev, workloads, n, seed):
    """W workloads' own n designs each, their tables padded to Lmax."""
    from repro_torch.soc.workloads import pad_workloads

    space = make_space()
    W = len(workloads)
    idx = space.sample(torch.Generator().manual_seed(seed), W * n).numpy()
    vals = torch.as_tensor(space.values(idx).reshape(W, n, -1),
                           dtype=torch.float32, device=dev).contiguous()
    layers, mask = pad_workloads([get_workload(w) for w in workloads])
    return (vals, torch.as_tensor(layers, dtype=torch.float32, device=dev),
            torch.as_tensor(mask, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("n", [2, 40, 60, 2500])
@pytest.mark.parametrize("workloads", [FLEET_WORKLOADS,
                                       ("resnet50", "minicpm3-4b")])
def test_systolic_eval_multi_matches_plain_and_single_launches(dev, n,
                                                               workloads):
    """K1's multi entry at the fleet's flush shapes against its plain
    version (K1's tolerance), and each workload's slice bitwise a single
    launch on that workload's own table; with minicpm3-4b (559 rows, kr 0)
    a 54-row workload is padded by 505 rows."""
    vals, layers, mask = _multi_inputs(dev, workloads, n, seed=n)
    W, lmax = len(workloads), layers.shape[1]
    before = K1.launches
    got = K1.soc_metrics_multi(vals, layers, mask)
    assert K1.launches == before + 1
    assert K1.multi_shape_launches[(W, n, lmax)] >= 1
    torch.testing.assert_close(
        got, K1.soc_metrics_multi_plain(vals, layers, mask), rtol=2e-5, atol=0)
    for w, wl in enumerate(workloads):
        own = torch.as_tensor(get_workload(wl), dtype=torch.float32,
                              device=dev)
        assert torch.equal(got[w], K1.soc_metrics(vals[w], own)), wl


def test_systolic_eval_multi_refuses_a_mask_that_is_not_a_prefix(dev):
    vals, layers, mask = _multi_inputs(dev, FLEET_WORKLOADS, 5, seed=1)
    mask[1, 3] = 0.0  # a hole in mobilenet's real layers
    got = K1.soc_metrics_multi(vals, layers, mask)
    assert torch.isnan(got[1]).all()
    assert torch.equal(got[0], K1.soc_metrics_multi(
        *_multi_inputs(dev, FLEET_WORKLOADS, 5, seed=1))[0])


def _k3_rows(n, m, seed):
    """Many ties, duplicated rows, two +inf rows, a row with a NaN and an
    all-NaN row."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 9, (n, m)).astype(np.float32)
    y[n // 2:] = y[: n - n // 2]
    y[3] = np.inf
    y[n - 3] = np.inf
    y[7, m // 2] = np.nan
    y[n - 1] = np.nan
    return y


@pytest.mark.parametrize("n", [50, 64, 70, 2500, 20_000])
@pytest.mark.parametrize("m", [3, 8])
def test_pareto_count_inf_and_nan_rows_equal_plain(dev, n, m):
    yt = torch.as_tensor(_k3_rows(n, m, n + m), device=dev)
    before = K3.launches
    got = K3.dominance_counts(yt)
    assert K3.launches == before + 1
    want = K3.dominance_counts_plain(yt)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
    assert int(got[7]) == 0 and int(got[n - 1]) == 0


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (63, 65, 26), (130, 257, 26),
                                   (64, 2500, 26), (200, 100, 40)])
def test_pairdist_matches_plain(dev, n, m, d):
    g = torch.Generator(device=dev).manual_seed(n + m + d)
    x = torch.rand((n, d), generator=g, device=dev)
    y = torch.rand((m, d), generator=g, device=dev)
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    atol = 2 * d * 2.0 ** -24 * scale  # cancellation in |x|^2+|y|^2-2xy
    torch.testing.assert_close(K2.pairdist(x, y), K2.pairdist_plain(x, y),
                               rtol=1e-5, atol=atol)
    inv2s2 = 1.0 / (2 * 0.9 ** 2 + 1e-12)
    torch.testing.assert_close(K2.pairdist(x, y, bandwidth=0.9),
                               K2.pairdist_plain(x, y, 0.9),
                               rtol=1e-5, atol=inv2s2 * atol + 1e-6)


@pytest.mark.parametrize("n,m", [(1, 3), (31, 3), (33, 2), (600, 3), (2500, 3),
                                 (700, 8)])
def test_pareto_count_equals_plain(dev, n, m):
    rng = np.random.default_rng(n * m)
    y = rng.integers(0, 7, (n, m)).astype(np.float32)  # many ties
    y[n // 2:] = y[: n - n // 2]                        # duplicated rows
    yt = torch.as_tensor(y, device=dev)
    got = K3.dominance_counts(yt)
    assert got.dtype == torch.int32
    assert torch.equal(got, K3.dominance_counts_plain(yt))


def test_wrappers_raise_instead_of_falling_back(dev):
    x = torch.rand((8, 6), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        K2.pairdist(x.t(), x.t())
    with pytest.raises(ValueError, match="different devices"):
        K2.pairdist(x, x.cpu())
    with pytest.raises(ValueError, match="objectives"):
        K3.dominance_counts(torch.rand((8, 9), device=dev))


K4_NAMES = ("ls", "var", "L", "V", "x", "beta", "ystar", "pool_c", "evalm_c",
            "y_mean", "y_std", "weights")


def _k4_problem(dev, nc, C, d, P, m=3, S=10, seed=0):
    """A round problem on the card: SPD factors, a V consistent with them
    (from the plain version at s0 = 0), the last 5 columns of the last chunk
    masked as pad columns are."""
    rng = np.random.default_rng(seed)
    f = np.float32
    A = rng.normal(size=(m, P, P)) / np.sqrt(P)
    evalm = np.zeros((nc, C), bool)
    evalm[0, :3] = True
    evalm[-1, C - 5:] = True
    sc = 1.5 / np.sqrt(d)
    p = dict(ls=np.exp(0.3 * rng.normal(size=(m, d))),
             var=np.exp(0.2 * rng.normal(size=(m,))),
             L=np.linalg.cholesky(A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(P)),
             V=np.zeros((nc, m, P, C)), x=sc * rng.normal(size=(P, d)),
             beta=rng.normal(size=(m, P)), ystar=rng.normal(size=(S, m)),
             pool_c=sc * rng.normal(size=(nc, C, d)), evalm_c=evalm,
             y_mean=np.linspace(-1, 1, m), y_std=np.linspace(0.5, 2, m),
             weights=np.linspace(0.2, 1, m))
    t = {k: torch.as_tensor(v if v.dtype == bool else v.astype(f), device=dev)
         for k, v in p.items()}
    K4.round_select_plain(*(t[k] for k in K4_NAMES), s0=0)
    return t


def _k4_both(t, s0):
    """(kernel V, kernel index, plain V, plain index) on copies of ``t``."""
    a = {k: v.clone() for k, v in t.items()}
    b = {k: v.clone() for k, v in t.items()}
    before = K4.launches
    va, ia = K4.round_select(*(a[k] for k in K4_NAMES), s0=s0)
    assert K4.launches == before + 1
    vb, ib = K4.round_select_plain(*(b[k] for k in K4_NAMES), s0=s0)
    torch.cuda.synchronize()
    return va, int(ia), vb, int(ib)


@pytest.mark.parametrize("nc,C,P,s0", [
    (1, 2500, 72, 0), (1, 2500, 72, 64), (1, 2500, 72, 72), (1, 2500, 72, 99),
    (5, 512, 256, 248), (3, 37, 8, 0), (3, 37, 8, 5), (2, 130, 256, 0)])
def test_round_fused_matches_plain(dev, nc, C, P, s0):
    t = _k4_problem(dev, nc, C, 11, P, seed=nc * C + P + s0)
    va, ia, vb, ib = _k4_both(t, s0)
    assert ia == ib
    # expf/erff/logf against correctly rounded float64 ones, through the
    # substitution: 2e-5, the tolerance of the JAX kernel tests
    torch.testing.assert_close(va, vb, rtol=2e-5, atol=2e-5)
    if s0 >= P:
        assert torch.equal(va, t["V"])


def test_round_fused_ties_and_nan_chunks(dev):
    t = _k4_problem(dev, 3, 200, 7, 16, seed=4)
    _, win, _, _ = _k4_both(t, 0)
    j, c = divmod(win, 200)
    for jj, cc in ((j, 199 if c < 199 else 198), ((j + 1) % 3, 5)):
        t["pool_c"][jj, cc] = t["pool_c"][j, c]
    _, ia, _, ib = _k4_both(t, 0)
    assert ia == ib == min(win, ((j + 1) % 3) * 200 + 5,
                           j * 200 + (199 if c < 199 else 198))
    t["pool_c"][ia // 200, (ia + 1) % 200] = float("nan")  # poison that chunk
    _, ia2, vb2, ib2 = _k4_both(t, 0)
    assert ia2 == ib2 and ia2 // 200 != ia // 200
    t["L"].fill_(float("nan"))
    assert _k4_both(t, 0)[1] == _k4_both(t, 0)[3] == 0


def test_profiled_rounds_launch_round_fused_once_each(dev):
    """Profile mode times the round the main path runs: one K4 launch per
    round, and the picks of the unprofiled engine."""
    from repro_torch.core import BOEngine
    from repro_torch.core.engine import PROFILE_STAGES
    from repro_torch.random import GeneratorDraws

    rng = np.random.default_rng(5)
    pool = rng.uniform(size=(96, 6)).astype(np.float32)
    y = np.stack([pool.sum(1), (pool ** 2).sum(1), -pool[:, 0]], 1)
    picks = {}
    for profile in (False, True):
        eng = BOEngine(pool, gp_steps=20, profile_stages=profile, device=dev)
        eng.observe(list(range(10)), y[:10])
        draws, out = GeneratorDraws(2, "cpu"), []
        for _ in range(3):
            sub, eps = draws.round(96, 32, 3, 4)
            before = K4.launches
            out.append(eng.select(eps, sub))
            assert K4.launches == before + 1
            eng.observe(out[-1:], y[out[-1:]])
        picks[profile] = out
    assert picks[True] == picks[False]
    assert set(eng.stats.stage_wall_s) == set(PROFILE_STAGES) | {"round_total"}


def test_small_tuner_on_the_card_picks_what_the_cpu_picks(dev):
    from repro_torch.core import soc_tuner
    from repro_torch.random import GeneratorDraws
    from repro_torch.soc import VLSIFlow

    space = make_space()
    pool = space.sample(torch.Generator().manual_seed(7), 64).numpy()
    for kw in (dict(), dict(incremental=True), dict(incremental=True, q=2),
               dict(incremental=True, pool_chunk=24)):
        rows = {}
        for d in ("cuda", "cpu"):
            flow = VLSIFlow(space, "resnet50", device=d)
            rows[d] = soc_tuner(space, pool, flow, T=4, n=10, b=8, gp_steps=25,
                                draws=GeneratorDraws(3, "cpu"), device=d,
                                **kw).evaluated_rows
        np.testing.assert_array_equal(rows["cuda"], rows["cpu"])



# K4's two uses on a mutable pool: a pool edit's chunk refresh (s0 = 0 on
# gathered dirty chunks) and the pool scores (s0 >= P with ``scores`` out).
@pytest.mark.parametrize("nc,C,P,dirty", [
    (5, 512, 72, [3]), (5, 512, 72, [0, 2, 4]), (1, 2500, 72, [0]),
    (4, 50, 24, [1, 3])])
def test_round_fused_refresh_is_bitwise_a_full_launch(dev, nc, C, P, dirty):
    """Refreshed chunks (their V set to NaN first: every row is recomputed)
    equal the same chunks of one full s0 = 0 launch bit for bit, and the
    plain version within K4's tolerance; one ``refresh`` launch."""
    t = _k4_problem(dev, nc, C, 26, P, seed=nc * C + len(dirty))
    full = {k: v.clone() for k, v in t.items()}
    V_full, _ = K4.round_select(*(full[k] for k in K4_NAMES), s0=0)
    didx = torch.as_tensor(dirty, device=dev)
    g = dict(t, V=torch.full_like(t["V"][didx], float("nan")),
             pool_c=t["pool_c"][didx], evalm_c=t["evalm_c"][didx])
    before = dict(K4.class_launches)
    K4.refresh_chunks(*(g[k] for k in K4_NAMES), nc_full=nc)
    torch.cuda.synchronize()
    assert K4.class_launches["refresh"] == before["refresh"] + 1
    assert K4.class_launches["refactor"] == before["refactor"]
    assert torch.equal(g["V"], V_full[didx])
    plain = {k: (v.cpu() if k != "V" else torch.zeros_like(v, device="cpu"))
             for k, v in g.items()}
    K4.refresh_chunks(*(plain[k] for k in K4_NAMES), nc_full=nc)
    # expf against a correctly rounded exp through the substitution
    torch.testing.assert_close(g["V"].cpu(), plain["V"], rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("nc,C,P", [(1, 2500, 72), (16, 16384, 72),
                                    (3, 37, 8), (5, 512, 256)])
def test_round_fused_scores_match_plain(dev, nc, C, P):
    """The scores a score-only launch writes: the plain version's within
    rtol = atol = 2e-5, ``-inf`` on the same (evaluated, pad) columns, the
    first-index argmax of the scores is the pick of the same launch, V is
    untouched; one ``scores`` launch."""
    t = _k4_problem(dev, nc, C, 26, P, seed=C + P)
    V0 = t["V"].clone()
    sk = torch.empty((nc, C), device=dev)
    sp = torch.empty((nc, C), device=dev)
    before = dict(K4.class_launches)
    _, ik = K4.round_select(*(t[k] for k in K4_NAMES), s0=P, scores=sk)
    _, ip = K4.round_select_plain(*(t[k] for k in K4_NAMES), s0=P, scores=sp)
    torch.cuda.synchronize()
    assert K4.class_launches["scores"] == before["scores"] + 1
    assert K4.class_launches["score_only"] == before["score_only"]
    assert torch.equal(t["V"], V0)
    a, b = sk.cpu().numpy(), sp.cpu().numpy()
    np.testing.assert_array_equal(np.isneginf(a), np.isneginf(b))
    assert np.isneginf(a).sum() == 3 + 5  # evaluated + pad columns
    live = np.isfinite(b)
    assert np.isfinite(a[live]).all()
    np.testing.assert_allclose(a[live], b[live], rtol=2e-5, atol=2e-5)
    assert int(np.argmax(a.reshape(-1))) == int(ik) == int(ip)


# The redesigned K4 at the edges of its launch plan (kernels/round_fused.py::
# launch_plan): L in panels through the ring (P = 512 at s0 = 0), wide
# features, one and five objectives, one column a chunk, a ragged last chunk.
@pytest.mark.parametrize("nc,C,d,P,m,s0,pad", [
    (2, 37, 11, 512, 3, 0, 5),    # L in panels (1 MB an objective)
    (2, 37, 11, 512, 3, 504, 5),  # block update at P = 512
    (2, 40, 64, 24, 1, 0, 5),     # d = 64, one objective
    (2, 40, 64, 24, 5, 16, 5),    # d = 64, five objectives (two waves)
    (7, 1, 11, 16, 3, 0, 0),      # one column a chunk
    (4, 50, 26, 72, 3, 64, 23),   # ragged last chunk: 23 pad columns
    (3, 200, 26, 72, 3, 0, 0)])
def test_round_fused_plan_edges_match_plain(dev, nc, C, d, P, m, s0, pad):
    t = _k4_problem(dev, nc, C, d, P, m=m, seed=nc + C + d + P + m + s0)
    t["evalm_c"][-1] = False
    t["evalm_c"][0, :min(3, C)] = True
    if pad:
        t["evalm_c"][-1, C - pad:] = True
    va, ia, vb, ib = _k4_both(t, s0)
    assert ia == ib
    # the same tolerance as test_round_fused_matches_plain
    torch.testing.assert_close(va, vb, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("C,d,P,s0,lmode,xs,pv_all", [
    (8, 5, 3500, 0, "DEVICE", 1, True),       # L read from device memory
    (8, 6000, 16, 0, "DEVICE", 0, True),      # pool and x divided inline
    (8, 5, 12000, 11992, "DEVICE", 0, False)])  # V rows >= pv in device memory
def test_round_fused_device_memory_modes_match_plain(dev, C, d, P, s0, lmode,
                                                     xs, pv_all):
    """Where even the smallest staging does not fit in shared memory, the
    same kernel reads that part from device memory (one objective, one
    chunk; L built triangular and well conditioned, V from the plain
    version at s0 = 0)."""
    plan = K4.launch_plan(1, C, d, 1, P, s0)
    assert (plan["lmode"], plan["xs"], plan["pv"] == P) == \
        (getattr(K4, lmode), xs, pv_all)
    rng = np.random.default_rng(P + d)
    sc = 1.5 / np.sqrt(d)
    L = np.tril(rng.standard_normal((P, P), dtype=np.float32)) * np.float32(
        0.3 / np.sqrt(P))
    L[np.diag_indices(P)] = 1.0 + rng.random(P, dtype=np.float32)
    p = dict(ls=np.exp(0.3 * rng.normal(size=(1, d))),
             var=np.ones(1), L=L[None], V=np.zeros((1, 1, P, C)),
             x=sc * rng.normal(size=(P, d)), beta=rng.normal(size=(1, P)),
             ystar=rng.normal(size=(10, 1)),
             pool_c=sc * rng.normal(size=(1, C, d)),
             evalm_c=np.zeros((1, C), bool), y_mean=np.zeros(1),
             y_std=np.ones(1), weights=np.ones(1))
    t = {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.float32),
                            device=dev) for k, v in p.items()}
    del L, p
    K4.round_select_plain(*(t[k] for k in K4_NAMES), s0=0)
    va, ia, vb, ib = _k4_both(t, s0)
    assert ia == ib
    # the same tolerance as test_round_fused_matches_plain
    torch.testing.assert_close(va, vb, rtol=2e-5, atol=2e-5)

def test_round_fused_is_deterministic(dev):
    """Two calls on the same inputs give bitwise-equal V and the same pick
    (the argmax's atomics do not depend on their order)."""
    for nc, C, P, s0 in ((1, 2500, 72, 0), (3, 517, 72, 64)):
        t = _k4_problem(dev, nc, C, 26, P, seed=C + s0)
        a = {k: v.clone() for k, v in t.items()}
        b = {k: v.clone() for k, v in t.items()}
        va, ia = K4.round_select(*(a[k] for k in K4_NAMES), s0=s0)
        vb, ib = K4.round_select(*(b[k] for k in K4_NAMES), s0=s0)
        torch.cuda.synchronize()
        assert torch.equal(va, vb) and int(ia) == int(ib)


def test_round_fused_score_only_leaves_v_bitwise(dev):
    t = _k4_problem(dev, 2, 300, 26, 40, seed=3)
    for s0 in (40, 41, 1000):
        before = t["V"].clone()
        _, ia, _, ib = _k4_both(t, s0)
        assert ia == ib
        assert torch.equal(t["V"], before)


def test_round_fused_is_one_device_operation_per_call(dev):
    """One call is one kernel launch and nothing else on the device: no
    memset (the kernel's last block zeroes its scratch for the next call),
    no second pass; counted with torch.profiler after a warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    for nc, C, P, s0 in ((1, 2500, 72, 0), (5, 512, 256, 248),
                         (3, 37, 8, 8)):
        t = _k4_problem(dev, nc, C, 26, P, seed=1)
        args = [t[k] for k in K4_NAMES]
        K4.round_select(*args, s0=s0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            K4.round_select(*args, s0=s0)
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(ops) == 1, [e.name for e in ops]
        assert "round_kernel" in ops[0].name


@pytest.mark.parametrize("n,m,d", [(70, 131, 33), (9, 2501, 64), (130, 66, 100),
                                   (72, 70, 26), (1, 5, 7)])
def test_pairdist_wide_features_and_ragged_rows_match_plain(dev, n, m, d):
    """K2 with d > 32 (features staged in chunks) and m not a multiple of 4
    (the scalar store path); the tolerance of test_pairdist_matches_plain."""
    g = torch.Generator(device=dev).manual_seed(n * m + d)
    x = torch.rand((n, d), generator=g, device=dev)
    y = torch.rand((m, d), generator=g, device=dev)
    scale = float((x * x).sum(1).max() + (y * y).sum(1).max())
    atol = 2 * d * 2.0 ** -24 * scale
    before = K2.launches
    torch.testing.assert_close(K2.pairdist(x, y), K2.pairdist_plain(x, y),
                               rtol=1e-5, atol=atol)
    inv2s2 = 1.0 / (2 * 0.9 ** 2 + 1e-12)
    torch.testing.assert_close(K2.pairdist(x, y, bandwidth=0.9),
                               K2.pairdist_plain(x, y, 0.9),
                               rtol=1e-5, atol=inv2s2 * atol + 1e-6)
    assert K2.launches == before + 2
    assert K2.shape_launches[(n, m, d, "d2")] >= 1

# ------------------------------------------------------------ K5 flash_attn
# bf16 outputs are rounded from float32 results that differ in the last
# bits (another summation order), so one may flip by a bf16 ulp (<= 2^-7
# relative); float32 outputs agree to 2e-5.
K5_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=2.0 ** -7, atol=1e-3)}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 1, 4, 2, 16), (2, 77, 4, 2, 16), (1, 64, 4, 4, 64), (2, 200, 8, 2, 64),
    (1, 129, 4, 1, 128), (2, 512, 32, 8, 128), (1, 1000, 8, 8, 128),
    # the bf16 kernel's edges: a ragged last tile, one exact query tile,
    # the KV head h // 5 (qwen3-14b, 40/8) and h // 12 (starcoder2-3b,
    # 24/2), and hd 16 (32-byte swizzle) at a ragged S
    (1, 127, 8, 8, 128), (1, 128, 8, 2, 128), (2, 2000, 40, 8, 128),
    (1, 257, 24, 2, 128), (3, 129, 4, 2, 16)])
def test_flash_attn_matches_plain(dev, dtype, B, S, H, K, hd):
    from repro_torch.kernels import flash_attn as K5

    g = torch.Generator(device=dev).manual_seed(B * S + H + hd)
    q = torch.randn((B, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, K, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, K, hd), generator=g, device=dev).to(dtype)
    before = K5.launches
    got = K5.flash_attention(q, k, v)
    assert K5.launches == before + 1
    want = K5.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **K5_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("B,S,H,K,dqk,dv,scale_dim", [
    # MLA's un-absorbed prefill: minicpm3-4b's (96, 64) at 40 heads, a
    # single query, ragged tiles and a KV group; the smoke dims 24/16
    # zero-padded to (32, 16), scaled by 1/sqrt(24)
    (1, 1, 4, 4, 96, 64, 96), (1, 129, 8, 8, 96, 64, 96),
    (2, 300, 40, 40, 96, 64, 96), (1, 1000, 4, 2, 96, 64, 96),
    (2, 77, 4, 4, 32, 16, 24), (3, 129, 4, 4, 32, 16, 24),
    # deepseek-v2-lite's (192, 128) at 16 heads: one query, ragged tiles, a
    # KV group, and its prefill's S
    (1, 1, 4, 4, 192, 128, 192), (1, 129, 16, 16, 192, 128, 192),
    (2, 300, 16, 4, 192, 128, 192), (1, 2048, 16, 16, 192, 128, 192)])
def test_flash_attn_unequal_head_dims_match_plain(dev, dtype, B, S, H, K,
                                                  dqk, dv, scale_dim):
    from repro_torch.kernels import flash_attn as K5

    g = torch.Generator(device=dev).manual_seed(B * S + H + dqk)
    q = torch.randn((B, S, H, dqk), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, K, dqk), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, K, dv), generator=g, device=dev).to(dtype)
    scale = 1.0 / scale_dim ** 0.5
    before = K5.launches
    got = K5.flash_attention(q, k, v, scale=scale)
    assert K5.launches == before + 1
    want = K5.flash_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, S, H, dv)
    torch.testing.assert_close(got.float(), want.float(), **K5_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("window", [None, 2048, 100, 40])
@pytest.mark.parametrize("B,S", [(1, 1), (2, 300), (1, 2100)])
def test_flash_attn_head_dim_256_with_windows_matches_plain(dev, dtype,
                                                            window, B, S):
    """recurrentgemma-9b's K5: (256, 256), 16 query heads on one KV head
    (h // 16), the window of its config (2048) and windows that are not a
    multiple of the 64-key tile (100) or smaller than one (40), at S not a
    multiple of 64; the bf16 route's two-stage ring without the overlap."""
    from repro_torch.kernels import flash_attn as K5

    g = torch.Generator(device=dev).manual_seed(B * S + (window or 0))
    q = torch.randn((B, S, 16, 256), generator=g, device=dev).to(dtype)
    k = torch.randn((B, S, 1, 256), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, 1, 256), generator=g, device=dev).to(dtype)
    before = K5.launches
    got = K5.flash_attention(q, k, v, window=window)
    assert K5.launches == before + 1
    want = K5.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **K5_TOL[dtype])
    if window is not None and window <= S // 2:  # the window matters
        full = K5.flash_attention_plain(q, k, v)
        assert float((full.float() - want.float()).abs().max()) > 0.05


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("window", [1, 40, 64, 100, 129])
@pytest.mark.parametrize("dqk,dv,H,K", [(16, 16, 4, 1), (64, 64, 4, 2),
                                        (128, 128, 8, 2), (96, 64, 8, 8),
                                        (192, 128, 4, 4), (32, 16, 4, 4)])
def test_flash_attn_windows_at_every_head_dim_match_plain(dev, dtype, window,
                                                          dqk, dv, H, K):
    """A window at each of the other head-dim pairs (the overlapped bf16
    loop, three ring stages): one key (1), under a tile (40), one tile
    (64), ragged (100, 129), at a ragged S; and ``window=None`` or a window
    that covers S gives the causal kernel's result bit for bit."""
    from repro_torch.kernels import flash_attn as K5

    S = 333
    g = torch.Generator(device=dev).manual_seed(S + dqk + window)
    q = torch.randn((2, S, H, dqk), generator=g, device=dev).to(dtype)
    k = torch.randn((2, S, K, dqk), generator=g, device=dev).to(dtype)
    v = torch.randn((2, S, K, dv), generator=g, device=dev).to(dtype)
    got = K5.flash_attention(q, k, v, window=window)
    want = K5.flash_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), **K5_TOL[dtype])
    causal = K5.flash_attention(q, k, v)
    assert torch.equal(causal, K5.flash_attention(q, k, v, window=S))
    assert torch.equal(causal, K5.flash_attention(q, k, v, window=10 * S))


def test_mla_smoke_prefill_on_the_card_matches_the_cpu(dev):
    """minicpm3-4b@smoke on the card: one K5 launch a layer at the padded
    dims (32, 16) on the tensor-core route, none in decode; prefill and
    decode logits within the CPU tests' 0.0625 of the CPU's plain run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import decode_step, init, init_cache, prefill

    cfg = get_config("minicpm3-4b@smoke")
    cpu = init(cfg, torch.Generator().manual_seed(4), "cpu")
    card = init(cfg, torch.Generator().manual_seed(4), "cpu").to(dev)
    toks = torch.randint(0, cfg.vocab, (2, 90),
                         generator=torch.Generator().manual_seed(5))
    logits = {}
    for name, model, d in (("cuda", card, dev), ("cpu", cpu, "cpu")):
        before = dict(K5.route_launches)
        cache, lg = prefill(model, toks.to(d))
        dec = init_cache(cfg, 2, 91, device=d)
        for field, c in zip(dec, cache):
            field[:, :, :90] = c
        _, lg2 = decode_step(model, dec, toks[:, 0].to(d), 90)
        moved = {r: n - before[r] for r, n in K5.route_launches.items()}
        assert moved == ({"tensor_core": cfg.n_layers, "cuda_core": 0}
                         if name == "cuda" else
                         {"tensor_core": 0, "cuda_core": 0})
        logits[name] = (lg.float().cpu(), lg2.float().cpu())
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0.0625)


def _moe_layer(dev, arch="deepseek-v2-lite-16b@smoke", seed=6):
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    cfg = get_config(arch)
    layer = moe.MoE(cfg, "cpu")
    layer.reset_parameters(torch.Generator().manual_seed(seed))
    return cfg, layer.to(dev)


def test_moe_apply_on_the_card_is_bitwise_repeatable(dev):
    """Two bf16 runs of the card's ``moe_apply`` (capacity factor 0.5, so
    experts overflow and drop) give the same bits: the combine sums each
    token's experts in a fixed order, with no atomics."""
    import dataclasses

    from repro_torch.models import moe

    cfg, layer = _moe_layer(dev)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    x = torch.randn((3, 200, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    x = x.to(torch.bfloat16)
    y1, aux1 = moe.moe_apply(layer, cfg, x)
    y2, aux2 = moe.moe_apply(layer, cfg, x)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)


def test_moe_apply_float32_on_the_card_matches_the_cpu(dev):
    """float32 (TF32 off): the card's routing, slots and drops equal the
    CPU's, and the outputs agree to float32 sums in another order."""
    import dataclasses

    from repro_torch.models import moe

    cfg, layer = _moe_layer(dev)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    # scaled so that the outputs are O(1), as in tests/test_torch_moe.py
    x = 0.2 * torch.randn((3, 200, cfg.d_model),
                          generator=torch.Generator().manual_seed(2))
    out = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        seen = []

        def record(probs, k):
            seen.append(moe.route(probs, k))
            return seen[-1]

        y, _ = moe.moe_apply(layer.to(d), cfg, x.to(d), routing=record)
        out[name] = (y.cpu(), seen[0].cpu())
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    slots = moe.arrival_slots(out["cpu"][1].reshape(-1), cfg.n_experts)
    assert bool((slots >= moe.capacity(600, cfg.top_k, cfg.n_experts,
                                       0.5)).any())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b@smoke",
                                  "deepseek-v2-lite-16b@smoke"])
def test_moe_smoke_prefill_on_the_card_matches_the_cpu(dev, arch):
    """The MoE smoke configs on the card: one tensor-core K5 launch a layer
    in the prefill (deepseek's MLA at the padded (32, 16)), none in decode;
    prefill and decode logits within the CPU tests' 0.0625 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import decode_step, init, init_cache, prefill

    cfg = get_config(arch)
    cpu = init(cfg, torch.Generator().manual_seed(4), "cpu")
    card = init(cfg, torch.Generator().manual_seed(4), "cpu").to(dev)
    toks = torch.randint(0, cfg.vocab, (2, 90),
                         generator=torch.Generator().manual_seed(5))
    logits = {}
    for name, model, d in (("cuda", card, dev), ("cpu", cpu, "cpu")):
        before = dict(K5.route_launches)
        cache, lg = prefill(model, toks.to(d))
        dec = init_cache(cfg, 2, 91, device=d)
        for field, c in zip(dec, cache):
            field[:, :, :90] = c
        _, lg2 = decode_step(model, dec, toks[:, 0].to(d), 90)
        moved = {r: n - before[r] for r, n in K5.route_launches.items()}
        assert moved == ({"tensor_core": cfg.n_layers, "cuda_core": 0}
                         if name == "cuda" else
                         {"tensor_core": 0, "cuda_core": 0})
        logits[name] = (lg.float().cpu(), lg2.float().cpu())
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0.0625)


@pytest.mark.parametrize("arch", ["mamba2-370m@smoke",
                                  "recurrentgemma-9b@smoke"])
def test_ssm_and_hybrid_smoke_prefill_on_the_card_matches_the_cpu(dev, arch):
    """The SSM and hybrid smoke configs on the card: no K5 launch for
    mamba2, one tensor-core launch with the window of 32 for recurrentgemma
    (a 75-token prompt, so the hand-off goes through the ring and the decode
    step wraps it); prefill and decode logits within the CPU tests' 0.0625
    of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import decode_step, init, init_cache, prefill
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(arch)
    cpu = init(cfg, torch.Generator().manual_seed(4), "cpu")
    card = init(cfg, torch.Generator().manual_seed(4), "cpu").to(dev)
    toks = torch.randint(0, cfg.vocab, (2, 75),
                         generator=torch.Generator().manual_seed(5))
    logits = {}
    for name, model, d in (("cuda", card, dev), ("cpu", cpu, "cpu")):
        before = dict(K5.route_launches)
        cache, lg = prefill(model, toks.to(d))
        dec = Engine(cfg, model, ServeConfig(max_len=76))._merge_caches(
            init_cache(cfg, 2, 76, device=d), cache, 75)
        _, lg2 = decode_step(model, dec, toks[:, 0].to(d), 75)
        moved = {r: n - before[r] for r, n in K5.route_launches.items()}
        launches = int(cfg.family == "hybrid" and name == "cuda")
        assert moved == {"tensor_core": launches, "cuda_core": 0}
        logits[name] = (lg.float().cpu(), lg2.float().cpu())
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0.0625)


def test_flash_attn_routes_bf16_to_tensor_cores_and_f32_to_cuda_cores(dev):
    from repro_torch.kernels import flash_attn as K5

    for dtype, route in ((torch.bfloat16, "tensor_core"),
                         (torch.float32, "cuda_core")):
        q = torch.randn((1, 64, 4, 64), device=dev).to(dtype)
        kv = torch.randn((1, 64, 2, 64), device=dev).to(dtype)
        before = dict(K5.route_launches)
        K5.flash_attention(q, kv, kv)
        moved = {r: n - before[r] for r, n in K5.route_launches.items()}
        assert moved == {r: int(r == route) for r in moved}


def test_flash_attn_refuses_instead_of_falling_back(dev):
    from repro_torch.kernels import flash_attn as K5

    q = torch.zeros((1, 8, 4, 64), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        K5.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    with pytest.raises(ValueError, match="head dim"):
        K5.flash_attention(*(torch.zeros((1, 8, 4, 96), device=dev),) * 3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        K5.flash_attention(*(q.half(),) * 3)
    with pytest.raises(ValueError, match="different devices"):
        K5.flash_attention(q, q.cpu(), q)


def _deep_smoke(n_layers):
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("mistral-nemo-12b@smoke"),
                               n_layers=n_layers)


def test_prefill_launches_k5_once_per_layer_and_decode_never(dev):
    """40 layers (the mistral-nemo-12b depth, at smoke width): one K5 launch
    each in the prefill, none in decode; the logits match the prefill with
    K5's plain version passed in (bf16 end to end: ulp flips through the
    layers, ~0.7-magnitude logits, atol 0.0625)."""
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import init
    from repro_torch.models import prefill as lm_prefill
    from repro_torch.serve import Engine, ServeConfig

    cfg = _deep_smoke(40)
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab, (2, 96), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    counts = []

    def timed(name, fn, *args, **kw):
        before = K5.launches
        out = fn(*args, **kw)
        counts.append((name, K5.launches - before))
        return out

    out = Engine(cfg, model, ServeConfig(max_len=104)).generate(
        tokens, 8, timed=timed)
    assert out.shape == (2, 8)
    assert counts[0] == ("prefill", 40)
    assert [c for name, c in counts[1:]] == [0] * 8
    _, logits = lm_prefill(model, tokens)
    _, plain = lm_prefill(model, tokens, attention=K5.flash_attention_plain)
    torch.testing.assert_close(logits.float(), plain.float(), rtol=0,
                               atol=0.0625)


def test_cuda_prefill_refuses_what_k5_does_not_compute(dev):
    """Causal prefill at other positions on the card raises; it never drops
    to the plain version. A sliding window launches K5, and so does
    bidirectional attention (``causal=False``, whatever the positions)."""
    import copy
    import dataclasses

    from repro_torch.models import LM
    from repro_torch.models import attention as tattn
    from repro_torch.models import init

    cfg = _deep_smoke(1)
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    attn = model.layers[0].attn
    x = torch.randn((1, 16, cfg.d_model), device=dev).to(torch.bfloat16)
    pos = torch.arange(16, device=dev).expand(1, 16)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tattn.gqa_apply(attn, cfg, x, pos + 3)
    from repro_torch.kernels import flash_attn as K5

    before = dict(K5.route_launches)
    y, _ = tattn.gqa_apply(attn, cfg, x, pos + 3, causal=False,
                           use_rope=False)
    assert K5.route_launches["tensor_core"] == before["tensor_core"] + 1
    y_cpu, _ = tattn.gqa_apply(copy.deepcopy(attn).cpu(), cfg, x.cpu(),
                               None, causal=False, use_rope=False)
    torch.testing.assert_close(y.float().cpu(), y_cpu.float(), rtol=0,
                               atol=0.0625)
    # a window is K5's own now: it launches, and it never drops to _sdpa
    before = K5.launches
    tattn.gqa_apply(attn, dataclasses.replace(cfg, window=8), x, None)
    assert K5.launches == before + 1
    LM(dataclasses.replace(cfg, window=8), dev)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("S", [64, 65, 100, 1500, 2048])
@pytest.mark.parametrize("hd,H,K", [(16, 4, 2), (64, 6, 6), (128, 8, 2)])
def test_flash_attn_noncausal_matches_plain(dev, dtype, S, hd, H, K):
    """``causal=False`` (the whisper encoder's attention) on both routes:
    a tile multiple (64, 2048), ragged S where the zero keys TMA fills past
    S must stay masked (65: one real key in the last tile; 100; whisper's
    1500 = 23 x 64 + 28), KV groups among them; the result differs from
    the causal one."""
    from repro_torch.kernels import flash_attn as K5

    g = torch.Generator(device=dev).manual_seed(S + hd + H)
    q = torch.randn((2, S, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((2, S, K, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((2, S, K, hd), generator=g, device=dev).to(dtype)
    route = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
    before = K5.route_launches[route]
    got = K5.flash_attention(q, k, v, causal=False)
    assert K5.route_launches[route] == before + 1
    want = K5.flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), **K5_TOL[dtype])
    causal = K5.flash_attention_plain(q, k, v)
    assert float((causal.float() - want.float()).abs().max()) > 0.05


def test_flash_attn_refuses_a_window_without_the_causal_mask(dev):
    from repro_torch.kernels import flash_attn as K5

    q = torch.zeros((1, 64, 4, 64), device=dev, dtype=torch.bfloat16)
    before = K5.launches
    with pytest.raises(ValueError, match="window needs the causal mask"):
        K5.flash_attention(q, q, q, window=16, causal=False)
    assert K5.launches == before


@pytest.mark.parametrize("arch", ["whisper-tiny@smoke", "pixtral-12b@smoke"])
def test_encdec_and_vision_smoke_prefill_on_the_card_matches_the_cpu(dev,
                                                                     arch):
    """whisper-tiny@smoke on the card: its 2 encoder layers launch K5 with
    ``causal=False`` and its 2 decoder layers the causal K5, all on the
    tensor-core route, cross-attention in plain torch, none in decode;
    pixtral-12b@smoke one causal launch a layer with its 16 patch
    embeddings in the first slots. Prefill and decode logits within the CPU
    tests' 0.0625 of the CPU's plain run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import decode_step, init, init_cache, prefill
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_config(arch)
    cpu = init(cfg, torch.Generator().manual_seed(4), "cpu")
    card = init(cfg, torch.Generator().manual_seed(4), "cpu").to(dev)
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen)
    extra = {}
    if cfg.is_encdec:
        extra["frames"] = torch.randn((2, cfg.enc_len, cfg.d_model),
                                      generator=gen)
    else:
        extra["images"] = torch.randn((2, cfg.n_patches, cfg.d_model),
                                      generator=gen) / cfg.d_model ** 0.5
    logits = {}
    for name, model, d in (("cuda", card, dev), ("cpu", cpu, "cpu")):
        before = dict(K5.route_launches)
        cache, lg = prefill(model, toks.to(d),
                            **{k: t.to(d) for k, t in extra.items()})
        dec = Engine(cfg, model, ServeConfig(max_len=41))._merge_caches(
            init_cache(cfg, 2, 41, device=d), cache, 40)
        _, lg2 = decode_step(model, dec, toks[:, 0].to(d), 40)
        moved = {r: n - before[r] for r, n in K5.route_launches.items()}
        n_k5 = cfg.n_layers + (cfg.enc_layers if cfg.is_encdec else 0)
        assert moved == {"tensor_core": n_k5 if name == "cuda" else 0,
                         "cuda_core": 0}
        logits[name] = (lg.float().cpu(), lg2.float().cpu())
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=0, atol=0.0625)


# K1's and K3's one-operation checks run last in this file: run before
# test_round_fused_is_one_device_operation_per_call, their profiler
# sessions left that test's session with no device events on the card.
def _one_device_operation(fn, name, sessions=3):
    """``fn()`` runs one kernel named ``name`` on the device and nothing
    else (after a warm-up call), by torch.profiler. A session that records
    no device activity at all is a lost trace, not a count: the next one is
    read (at most ``sessions``); the first that records must show exactly
    one operation."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            break
    assert len(ops) == 1, [e.name for e in ops]
    assert name in ops[0].name


def test_systolic_eval_is_one_device_operation_per_call(dev):
    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(2), 2500).numpy()
    vals = torch.as_tensor(space.values(idx), dtype=torch.float32, device=dev)
    for workload in ("resnet50", "minicpm3-4b"):
        layers = torch.as_tensor(get_workload(workload), dtype=torch.float32,
                                 device=dev)
        for n in (1, 2500):
            v = vals[:n].contiguous()
            _one_device_operation(lambda: K1.soc_metrics(v, layers),
                                  "systolic_eval_kernel")


def test_pareto_count_is_one_device_operation_per_call(dev):
    for n in (64, 2500, 20_000):
        yt = torch.as_tensor(_k3_rows(n, 3, n), device=dev)
        _one_device_operation(lambda: K3.dominance_counts(yt),
                              "pareto_count_kernel")


def test_spawn_worker_k1_equals_the_parents_bitwise(dev):
    """A ``cuda`` flow sent to spawn workers: each worker opens its own
    context and loads the library the parent built; its K1 outputs are the
    parent's bit for bit, and its launches stay out of the parent's count."""
    from repro_torch.service import FlowPool
    from repro_torch.soc import VLSIFlow

    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(11), 6).numpy()
    flow = VLSIFlow(space, "resnet50", device="cuda")
    want = np.stack([flow(row[None])[0] for row in idx])
    before = K1.launches
    pool = FlowPool(flow, executor="process", max_workers=2)
    try:
        for r, row in enumerate(idx):
            pool.submit(r, row)
        got = pool.drain(min_done=len(idx))
    finally:
        pool.close()
    assert [r for _, r, _ in got] == list(range(len(idx)))
    np.testing.assert_array_equal(np.stack([y for _, _, y in got]), want)
    assert K1.launches == before


def test_thread_workers_count_every_k1_launch(dev):
    """Worker threads launch K1 concurrently; the count stays exact."""
    from repro_torch.service import FlowPool
    from repro_torch.soc import VLSIFlow

    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(12), 64).numpy()
    flow = VLSIFlow(space, "resnet50", device="cuda")
    want = np.stack([flow(row[None])[0] for row in idx])
    before, calls = K1.launches, flow.calls
    pool = FlowPool(flow, executor="thread", max_workers=8)
    try:
        for r, row in enumerate(idx):
            pool.submit(r, row)
        got = pool.drain(min_done=len(idx))
    finally:
        pool.close()
    assert K1.launches - before == flow.calls - calls == len(idx)
    np.testing.assert_array_equal(np.stack([y for _, _, y in got]), want)


# -------------------------------------------- the §IV comparison (baselines)
@pytest.mark.parametrize("n,m,chunk", [(4500, 4500, 4096), (2500, 2500, 1000),
                                       (300, 301, 1), (64, 2500, 7),
                                       (2500, 64, 512)])
def test_pairdist_chunked_blocks_are_the_monolithic_launchs_columns(
        dev, n, m, chunk):
    """Each block is one K2 launch whose columns are bitwise the monolithic
    launch's: every element sums over the features only, in one order,
    whatever the tile plan."""
    g = torch.Generator(device=dev).manual_seed(n + m + chunk)
    x = torch.rand((n, 26), generator=g, device=dev)
    y = torch.rand((m, 26), generator=g, device=dev)
    for bw in (None, 1.1):
        full = K2.pairdist(x, y, bandwidth=bw)
        before = K2.launches
        got = K2.pairdist_chunked(x, y, chunk=chunk, bandwidth=bw)
        assert K2.launches - before == -(-m // chunk)
        assert torch.equal(got, full)


def _hv_front(seed, n, m):
    rng = np.random.default_rng(seed)
    u = rng.dirichlet(np.ones(m), size=n) ** 0.5
    return np.vstack([u, u[: n // 4], np.full((2, m), 1.5)]), np.full(m, 1.2)


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("n", [10, 40])
def test_hypervolume_on_the_card_equals_the_cpu(dev, m, n):
    """Equal to the CPU's float64 sweeps; K3 launches: none for m = 1, one
    front for m = 2, and for m = 3 the front plus one 2-D slab a z-level."""
    from repro_torch.core import hypervolume
    from repro_torch.core.pareto import front_mask

    f, ref = _hv_front(n + m, n, m)
    before = K3.launches
    got = hypervolume(f, ref, device=dev)
    launches = K3.launches - before
    assert got == hypervolume(f, ref, device="cpu") and got > 0
    inside = f[np.all(f <= ref, axis=1)]
    zs = np.sort(inside[front_mask(inside, torch.device("cpu"))][:, -1])
    levels = int(np.sum(np.diff(np.append(zs, ref[-1])) > 0))
    assert launches == {1: 0, 2: 1, 3: 1 + levels}[m]


def test_nondominated_sort_on_the_card_equals_the_cpu(dev):
    from repro_torch.core import nondominated_sort

    rng = np.random.default_rng(2500)
    y = np.round(rng.random((2500, 3)), 3)  # duplicates and ties
    before = K3.launches
    got = nondominated_sort(y, device=dev)
    want = nondominated_sort(y, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert K3.launches - before == min(32, int(want.max()) + 1)


def test_simplified_flow_on_the_card_launches_no_kernel(dev):
    from repro_torch.soc import SimplifiedFlow, area_breakdown

    space = make_space()
    idx = space.sample(torch.Generator().manual_seed(4), 500).numpy()
    before = K1.launches
    got = SimplifiedFlow(space, "resnet50", device=dev)(idx)
    assert K1.launches == before
    np.testing.assert_allclose(
        got, SimplifiedFlow(space, "resnet50", device="cpu")(idx), rtol=1e-5)
    vals = torch.as_tensor(space.values(idx), dtype=torch.float32)
    on_card, on_cpu = area_breakdown(vals.to(dev)), area_breakdown(vals)
    for k in on_cpu:
        np.testing.assert_allclose(on_card[k], on_cpu[k], rtol=1e-6)


# ------------------------------------------------ K5's backward (training)
#: the backward's bf16 gradients against the plain float32 ones rounded to
#: bf16 (chip_smoke.py's K5_BWD_* constants): P and dS enter products as
#: bf16 (2^-9 relative), each output rounds once more. Elementwise
#: |err| <= rtol |plain| + atol, atol relative to the largest |plain| of the
#: element's 64-position tile (causal gradients shrink with the position,
#: so the whole tensor's largest entry would hide late positions), and
#: mean |err| <= mean_rel mean |plain|; both at least the forward's 1e-3,
#: where the exact gradient is 0 (S 1: dS = dP - D cancels to float32
#: rounding)
BWD_RTOL, BWD_ATOL_REL, BWD_ATOL_MIN = 2.0 ** -6, 2.0 ** -7, 1e-3
BWD_MEAN_REL, BWD_TILE = 2.0 ** -6, 64


def _bwd_inputs(dev, B, S, H, K, hd, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + S + H)
    q, k, v = (torch.randn((B, S, n, hd), generator=g, device=dev).bfloat16()
               for n in (H, K, K))
    dout = torch.randn((B, S, H, hd), generator=g, device=dev).bfloat16()
    return q, k, v, dout


def _bwd_close(got, want) -> bool:
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        S = b.shape[1]
        tile_max = torch.nn.functional.pad(
            b.abs().amax(dim=(0, 2, 3)), (0, -S % BWD_TILE)).view(
                -1, BWD_TILE).amax(1).repeat_interleave(BWD_TILE)[:S]
        atol = (BWD_ATOL_REL * tile_max).clamp_min(BWD_ATOL_MIN)
        if not bool((d <= BWD_RTOL * b.abs() + atol.view(1, S, 1, 1)).all()):
            return False
        if float(d.mean()) > max(BWD_MEAN_REL * float(b.abs().mean()),
                                 BWD_ATOL_MIN):
            return False
    return True


@pytest.mark.parametrize("B,S,H,K,hd", [
    (2, 2048, 24, 2, 128), (16, 128, 8, 4, 64), (2, 100, 8, 4, 64),
    (2, 2000, 24, 2, 128), (1, 4096, 32, 8, 128), (1, 1, 4, 2, 64),
    (3, 65, 8, 8, 128), (2, 300, 16, 1, 128), (2, 40, 8, 4, 64),
    (1, 333, 6, 2, 128), (1, 256, 4, 4, 128), (2, 2048, 32, 8, 128)])
def test_flash_attn_backward_matches_plain(dev, B, S, H, K, hd):
    """The backward kernel and the forward's row statistic against their
    plain versions (the lse within float32 sums in another order), at
    starcoder2-3b's and qwen3-100m's training shapes, ragged S, S 4096, one
    position, no grouping, 16 query heads on one KV head, S shorter than a
    tile, a part-filled last chunk, a grid of fewer blocks than SMs and
    pixtral-12b's and phi3.5-moe's training shape;
    four planted faults (D left out of dS, the mask shifted by a key, the
    last 64 keys left out, the lse 0.05 high from row S/2 on) fail the same
    tolerance."""
    from repro_torch.kernels import flash_attn as K5

    q, k, v, dout = _bwd_inputs(dev, B, S, H, K, hd)
    before = (K5.launches, K5.bwd_launches,
              K5.bwd_head_dim_launches.get((hd, hd), 0))
    out, lse, lo = K5.flash_attention_lse(q, k, v)
    got = K5.flash_attention_backward(q, k, v, out, lse, dout, out_lo=lo)
    assert (K5.launches, K5.bwd_launches,
            K5.bwd_head_dim_launches[(hd, hd)]) == tuple(
                n + 1 for n in before)
    out_p, lse_p, _ = K5.flash_attention_lse_plain(q, k, v)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out.float(), out_p.float(),
                               **K5_TOL[torch.bfloat16])
    want = K5.flash_attention_backward_plain(q, k, v, dout)
    assert [t.dtype for t in got] == [torch.bfloat16] * 3
    assert _bwd_close(got, want)
    # the same inputs twice: bitwise equal (no atomics anywhere)
    again = K5.flash_attention_backward(q, k, v, out, lse, dout, out_lo=lo)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if S > 1:
        scale = 1.0 / hd ** 0.5
        G = H // K
        qf = q.float().transpose(1, 2)
        kf = k.repeat_interleave(G, 2).float().transpose(1, 2)
        vf = v.repeat_interleave(G, 2).float().transpose(1, 2)
        dof = dout.float().transpose(1, 2)
        s = (qf @ kf.transpose(-1, -2)) * (scale * 1.4426950408889634)
        dp = dof @ vf.transpose(-1, -2)
        ones = torch.ones((S, S), dtype=torch.bool, device=dev)

        def grads(p, ds):
            def summed(t):
                return t.view(B, K, G, S, hd).sum(2).transpose(1, 2)
            return ((ds @ kf * scale).transpose(1, 2),
                    summed(ds.transpose(-1, -2) @ qf * scale),
                    summed(p.transpose(-1, -2) @ dof))

        def softmax(mask, row_lse):
            return torch.where(mask, torch.exp2(s - row_lse[..., None]), 0.0)

        p = softmax(ones.tril(), lse)
        assert not _bwd_close(grads(p, p * dp), want)        # no D
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)[..., None]
        p = softmax(ones.tril(1), lse)                      # mask shifted
        assert not _bwd_close(grads(p, p * (dp - delta)), want)
        pos = torch.arange(S, device=dev)
        p = softmax(ones.tril() & (pos < (S - 1) // 64 * 64), lse)
        assert not _bwd_close(grads(p, p * (dp - delta)), want)  # last keys
        p = softmax(ones.tril(), lse + 0.05 * (pos >= S // 2))   # late rows
        assert not _bwd_close(grads(p, p * (dp - delta)), want)


@pytest.mark.parametrize("B,S,H,K,dqk,dv,used", [
    (2, 2048, 40, 40, 96, 64, 96), (2, 2048, 16, 16, 192, 128, 192),
    (1, 333, 16, 16, 192, 128, 192), (2, 40, 4, 4, 32, 16, 24),
    (2, 300, 8, 2, 96, 64, 96), (1, 65, 4, 4, 32, 16, 24),
    (4, 64, 4, 4, 32, 16, 24)])
def test_flash_attn_backward_matches_plain_at_mla_dims(dev, B, S, H, K, dqk,
                                                       dv, used):
    """The backward at MLA's head dims (q·k ≠ v: minicpm3-4b's 96/64,
    deepseek-v2-lite-16b's 192/128, the smoke dims' 24/16 zero-padded to
    32/16 at scale 1/√24, also at the MLA smoke training's B 4 x S 64)
    against the plain version with the same
    tolerance, twice bitwise equal; the padded columns' dq and dk are 0."""
    from repro_torch.kernels import flash_attn as K5

    g = torch.Generator(device=dev).manual_seed(S + dqk)
    q, k, v = (torch.randn((B, S, n, d), generator=g, device=dev).bfloat16()
               for n, d in ((H, dqk), (K, dqk), (K, dv)))
    q[..., used:] = 0
    k[..., used:] = 0
    dout = torch.randn((B, S, H, dv), generator=g, device=dev).bfloat16()
    scale = 1.0 / used ** 0.5
    before = K5.bwd_head_dim_launches.get((dqk, dv), 0)
    out, lse, lo = K5.flash_attention_lse(q, k, v, scale)
    got = K5.flash_attention_backward(q, k, v, out, lse, dout, scale,
                                      out_lo=lo)
    assert K5.bwd_head_dim_launches[(dqk, dv)] == before + 1
    out_p, lse_p, _ = K5.flash_attention_lse_plain(q, k, v, scale)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    want = K5.flash_attention_backward_plain(q, k, v, dout, scale)
    assert [t.shape for t in got] == [q.shape, k.shape, v.shape]
    assert _bwd_close(got, want)
    assert not got[0][..., used:].any() and not got[1][..., used:].any()
    again = K5.flash_attention_backward(q, k, v, out, lse, dout, scale,
                                        out_lo=lo)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-lite-16b"])
def test_mla_smoke_training_runs_the_backward_kernel(dev, arch):
    """A train step at an MLA smoke config (q·k 24 zero-padded to 32, v 16;
    deepseek with MoE) on the card: 2 forward (remat) and 1 backward K5
    launch a layer, all at (32, 16); the loss within 1e-2 of the CPU's
    step from the same masters."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.train import (DataConfig, TrainConfig, adamw_init,
                                   init_params, make_batch, make_train_step)

    cfg = get_config(arch, smoke=True)
    dcfg = DataConfig(cfg.vocab, 64, 4)
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    losses = []
    for d in (dev, "cpu"):
        kernels.reset_launches()
        st = adamw_init({n: t.to(d, copy=True) for n, t in masters.items()})
        _, _, m = make_train_step(cfg, TrainConfig(), d)(
            st, make_batch(dcfg, 0, device=d), None)
        losses.append(float(m["loss"]))
        if d == dev:
            assert (K5.launches, K5.bwd_launches) == \
                (2 * cfg.n_layers, cfg.n_layers)
            assert K5.bwd_head_dim_launches == {(32, 16): cfg.n_layers}
    assert abs(losses[0] - losses[1]) <= 1e-2, losses


def test_flash_attn_autograd_runs_the_backward_kernel(dev):
    """A call that needs a gradient goes through the autograd Function:
    one forward launch (with the row statistic), one backward launch, and
    the gradients are the backward's on the forward's outputs."""
    from repro_torch.kernels import flash_attn as K5

    q, k, v, dout = _bwd_inputs(dev, 2, 300, 8, 2, 128, seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = (K5.launches, K5.bwd_launches)
    out = K5.flash_attention(*leaves)
    assert out.requires_grad and K5.launches == before[0] + 1
    out.backward(dout)
    assert K5.bwd_launches == before[1] + 1
    o, lse, lo = K5.flash_attention_lse(q, k, v)
    assert torch.equal(out.detach(), o)
    want = K5.flash_attention_backward(q, k, v, o, lse, dout, out_lo=lo)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))
    with torch.no_grad():  # serving: no row statistic, no graph
        assert not K5.flash_attention(*leaves).requires_grad


@pytest.mark.parametrize("variant", ["float32", "head_dims_64_128"])
def test_flash_attn_gradient_of_other_variants_raises(dev, variant):
    """A CUDA call that needs a gradient the backward does not take raises
    and never falls back: float32 inputs (the forward runs them without a
    gradient; the backward is bf16 only) raise NotImplementedError naming
    ROADMAP; a head-dim pair neither kernel is built for, (64, 128), is
    refused with or without a gradient. (Every mask and every pair of
    HEAD_DIMS has its backward.)"""
    from repro_torch.kernels import flash_attn as K5

    hd, hv, dtype = 128, 128, torch.bfloat16
    if variant == "float32":
        dtype = torch.float32
    else:
        hd, hv = 64, 128
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn((1, 64, 4, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((1, 64, 2, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((1, 64, 2, hv), generator=g, device=dev).to(dtype)
    if variant == "float32":
        with torch.no_grad():
            K5.flash_attention(q, k, v)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            K5.flash_attention(q.requires_grad_(True), k, v)
        return
    with pytest.raises(ValueError, match="head dims"):
        with torch.no_grad():
            K5.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dims"):
        K5.flash_attention(q.requires_grad_(True), k, v)


#: the backward under the masks the new configs need (B, S, H, K, Dqk, Dv,
#: window, causal): whisper-tiny's encoder (64/64, no causal mask, S 1500:
#: the last key tile ragged) and a ragged S 100; recurrentgemma-9b's step
#: (256/256, window 2048, S 4096), the edge [2, 1000, 16/1, W 100] and a
#: part-filled 256/256 S 333 causal; the smoke dims 16/16 under each mask
#: (the smoke twins' B 4 x S 64, 4/2 heads; window 32) and at S 100
BWD_MASK_SHAPES = [
    (2, 1500, 6, 6, 64, 64, None, False), (2, 100, 4, 4, 64, 64, None, False),
    (1, 4096, 16, 1, 256, 256, 2048, True),
    (2, 1000, 16, 1, 256, 256, 100, True),
    (1, 333, 4, 2, 256, 256, None, True), (1, 200, 4, 4, 256, 256, None, False),
    (4, 64, 4, 2, 16, 16, None, True), (4, 64, 4, 2, 16, 16, 32, True),
    (4, 64, 4, 2, 16, 16, None, False), (2, 100, 4, 4, 16, 16, 32, True),
    (2, 100, 4, 4, 16, 16, None, False), (2, 1000, 8, 2, 128, 128, 100, True)]


@pytest.mark.parametrize("B,S,H,K,dqk,dv,window,causal", BWD_MASK_SHAPES)
def test_flash_attn_backward_under_masks_matches_plain(dev, B, S, H, K, dqk,
                                                       dv, window, causal):
    """The backward with ``causal=False`` and with a window, at (16, 16),
    (64, 64), (256, 256) and (128, 128), against the plain version under
    the same mask (tile-scaled and mean tolerance), the row statistic
    against the plain one, twice bitwise equal, counted by mask; two
    planted faults (the last 64 keys left out, the lse 0.05 high from row
    S/2 on) fail the same tolerance."""
    from repro_torch.kernels import flash_attn as K5

    g = torch.Generator(device=dev).manual_seed(S + dqk + H)
    q, k, v = (torch.randn((B, S, n, d), generator=g, device=dev).bfloat16()
               for n, d in ((H, dqk), (K, dqk), (K, dv)))
    dout = torch.randn((B, S, H, dv), generator=g, device=dev).bfloat16()
    scale = dqk ** -0.5
    cls = "noncausal" if not causal else "window" if window else "causal"
    before = K5.bwd_class_launches[cls]
    out, lse, lo = K5.flash_attention_lse(q, k, v, scale, window, causal)
    got = K5.flash_attention_backward(q, k, v, out, lse, dout, scale, window,
                                      causal, out_lo=lo)
    assert K5.bwd_class_launches[cls] == before + 1
    out_p, lse_p, lo_p = K5.flash_attention_lse_plain(q, k, v, scale, window,
                                                      causal)
    torch.testing.assert_close(lse, lse_p, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out.float(), out_p.float(),
                               **K5_TOL[torch.bfloat16])
    # out + its low part: the float32 output to ~16 bits (P as bf16 hi +
    # lo products, float32 sums in another order)
    torch.testing.assert_close(out.float() + lo.float(),
                               out_p.float() + lo_p.float(),
                               rtol=2.0 ** -12, atol=1e-4)
    want = K5.flash_attention_backward_plain(q, k, v, dout, scale, window,
                                             causal)
    assert _bwd_close(got, want)
    again = K5.flash_attention_backward(q, k, v, out, lse, dout, scale,
                                        window, causal, out_lo=lo)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    G = H // K
    qf = q.float().transpose(1, 2)
    kf = k.repeat_interleave(G, 2).float().transpose(1, 2)
    vf = v.repeat_interleave(G, 2).float().transpose(1, 2)
    dof = dout.float().transpose(1, 2)
    s = (qf @ kf.transpose(-1, -2)) * (scale * K5.LOG2E)
    dp = dof @ vf.transpose(-1, -2)
    pos = torch.arange(S, device=dev)
    mask = torch.ones((S, S), dtype=torch.bool, device=dev)
    if causal:
        mask = mask.tril()
        if window:
            mask &= ~torch.ones_like(mask).tril(-window)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)[..., None]

    def grads(keep, row_lse):
        p = torch.where(keep, torch.exp2(s - row_lse[..., None]), 0.0)
        ds = p * (dp - delta)

        def summed(t):
            return t.view(B, K, G, S, t.shape[-1]).sum(2).transpose(1, 2)
        return ((ds @ kf * scale).transpose(1, 2),
                summed(ds.transpose(-1, -2) @ qf * scale),
                summed(p.transpose(-1, -2) @ dof))

    assert not _bwd_close(grads(mask & (pos < (S - 1) // 64 * 64), lse),
                          want)                             # last keys
    assert not _bwd_close(grads(mask, lse + 0.05 * (pos >= S // 2)), want)


def test_flash_attn_autograd_takes_every_mask(dev):
    """Calls that need a gradient with ``causal=False`` and with a window
    go through the autograd Function: one forward (with the row statistic)
    and one backward launch each, under the call's mask."""
    from repro_torch.kernels import flash_attn as K5

    for kw, cls in ((dict(causal=False), "noncausal"),
                    (dict(window=40), "window")):
        q, k, v, dout = _bwd_inputs(dev, 2, 130, 4, 2, 64, seed=2)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = (K5.bwd_launches, K5.bwd_class_launches[cls])
        out = K5.flash_attention(*leaves, **kw)
        out.backward(dout)
        assert (K5.bwd_launches, K5.bwd_class_launches[cls]) == \
            (before[0] + 1, before[1] + 1)
        o, lse, lo = K5.flash_attention_lse(q, k, v, **kw)
        assert torch.equal(out.detach(), o)
        want = K5.flash_attention_backward(q, k, v, o, lse, dout, **kw,
                                           out_lo=lo)
        assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


@pytest.mark.parametrize("arch", ["whisper-tiny", "recurrentgemma-9b",
                                  "mamba2-370m", "qwen3-14b"])
def test_smoke_training_of_every_family_runs_the_backward_kernel(dev, arch):
    """A train step at the smoke configs of the encoder-decoder (whisper:
    frames in the batch; its encoder K5 without the causal mask, outside
    remat), the hybrid (window 32 at S 64), SSM (no K5) and a dense one
    (16/16) on the card: K5's launches a step by mask follow from remat
    (2 forward and 1 backward a decoder attention layer, 1 and 1 an
    encoder layer), all at (16, 16); the loss within 1e-2 of the CPU's step
    from the same masters."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.models import layer_kinds
    from repro_torch.train import (DataConfig, TrainConfig, adamw_init,
                                   init_params, make_batch, make_train_step)

    cfg = get_config(arch, smoke=True)
    dcfg = DataConfig(cfg.vocab, 64, 4)
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    frames = torch.randn((4, cfg.enc_len, cfg.d_model),
                         generator=torch.Generator().manual_seed(1)) \
        if cfg.is_encdec else None
    n_attn = sum(kind != "ssm" and kind != "rglru"
                 for kind in layer_kinds(cfg))
    n_enc = cfg.enc_layers if cfg.is_encdec else 0
    losses = []
    for d in (dev, "cpu"):
        kernels.reset_launches()
        st = adamw_init({n: t.to(d, copy=True) for n, t in masters.items()})
        batch = make_batch(dcfg, 0, device=d)
        if frames is not None:
            batch["frames"] = frames.to(d)
        _, _, m = make_train_step(cfg, TrainConfig(), d)(st, batch, None)
        losses.append(float(m["loss"]))
        if d == dev:
            assert (K5.launches, K5.bwd_launches) == \
                (2 * n_attn + n_enc, n_attn + n_enc)
            assert K5.bwd_class_launches == {
                "causal": 0 if cfg.window else n_attn,
                "window": n_attn if cfg.window else 0, "noncausal": n_enc}
            assert K5.bwd_head_dim_launches == (
                {(16, 16): n_attn + n_enc} if n_attn else {})
    assert abs(losses[0] - losses[1]) <= 1e-2, losses


def test_training_steps_on_the_card_are_repeatable_and_count_k5(dev):
    """Two runs of 3 train steps (a 2-layer qwen3-style model at head dim
    64, remat on) from the same masters end bit for bit equal, with 2
    forward (remat) and 1 backward K5 launch a layer a step; the masters
    moved."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as K5
    from repro_torch.train import (DataConfig, TrainConfig, adamw_init,
                                   init_params, make_batch, make_train_step)

    cfg = dataclasses.replace(
        get_config("qwen3-14b", smoke=True), d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=64, remat=True)
    dcfg = DataConfig(cfg.vocab, 96, 4)
    masters = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(cfg, TrainConfig(), dev)
    states = []
    for _ in range(2):
        kernels.reset_launches()
        st = adamw_init({n: t.to(dev, copy=True) for n, t in masters.items()})
        for i in range(3):
            st, _, m = step(st, make_batch(dcfg, i, device=dev), None)
        torch.cuda.synchronize()
        assert (K5.launches, K5.bwd_launches) == (2 * 2 * 3, 2 * 3)
        states.append(st)
    a, b = states
    assert all(torch.equal(a.params[n], b.params[n]) and
               torch.equal(a.m[n], b.m[n]) and torch.equal(a.v[n], b.v[n])
               for n in a.params)
    assert not torch.equal(a.params["layers.0.attn.wq"].cpu(),
                           masters["layers.0.attn.wq"])
