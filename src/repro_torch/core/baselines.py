"""Baselines the paper compares against (§IV-A), on PyTorch.

* ``random``      — uniform exploration of the pool.
* ``regression``  — Lee & Brooks HPCA'07-style polynomial ridge regression
                    with quadratic and near-neighbour interaction terms.
* ``xgb``         — gradient-boosted regression trees (compact
                    reimplementation).
* ``rf``          — random forest regression.
* ``svr``         — RBF kernel ridge regression (the dual-form SVR stand-in).
* ``microal``     — BOOM-Explorer (ICCAD'21)-style: TED init (no ICD), GP
                    surrogate, Monte-Carlo Expected HyperVolume Improvement.

The surrogate baselines propose by simulated annealing over the pool with
Chebyshev scalarization. Every baseline spends SoC-Tuner's budget: b init
designs in one flow call, then one design a round for T rounds.

A copy of ``repro.core.baselines``: the trees, the ridge models and the
annealer are host numpy and use the numpy generator call by call as the
reference does, so one seed gives the same draws. The seed comes from
``draws.baseline_seed()`` (:class:`repro_torch.random.TunerDraws`).
``microal``'s TED and GP run on ``device`` (``pairdist`` kernel), and every
front, sort and hypervolume decides dominance there (``pareto_count``).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.random import GeneratorDraws, TunerDraws

from .gp import fit_gp, gp_predict
from .pareto import adrs, front_mask, hypervolume
from .sampling import ted_select
from .space import DesignSpace
from .tuner import TunerResult

FlowFn = Callable[[np.ndarray], np.ndarray]

__all__ = ["run_baseline", "BASELINES"]

BASELINES = ("random", "regression", "xgb", "rf", "svr", "microal")


# --------------------------------------------------------------------- trees
class _Tree:
    """Depth-limited CART regression tree on float features."""

    def __init__(self, max_depth=4, min_leaf=4, n_feat=None, rng=None):
        self.max_depth, self.min_leaf, self.n_feat = max_depth, min_leaf, n_feat
        self.rng = rng or np.random.default_rng(0)
        self.nodes: list[tuple] = []  # (feat, thr, left, right) or ('leaf', value)

    def _build(self, X, y, depth):
        node_id = len(self.nodes)
        self.nodes.append(None)
        if depth >= self.max_depth or len(y) < 2 * self.min_leaf or np.ptp(y) < 1e-12:
            self.nodes[node_id] = ("leaf", float(y.mean()))
            return node_id
        d = X.shape[1]
        feats = (self.rng.choice(d, self.n_feat, replace=False)
                 if self.n_feat and self.n_feat < d else np.arange(d))
        best = None
        base = ((y - y.mean()) ** 2).sum()
        for f in feats:
            xs = np.unique(X[:, f])
            if xs.size < 2:
                continue
            for thr in (xs[:-1] + xs[1:]) / 2:
                m = X[:, f] <= thr
                nl, nr = m.sum(), (~m).sum()
                if nl < self.min_leaf or nr < self.min_leaf:
                    continue
                sse = (((y[m] - y[m].mean()) ** 2).sum()
                       + ((y[~m] - y[~m].mean()) ** 2).sum())
                gain = base - sse
                if best is None or gain > best[0]:
                    best = (gain, f, thr, m)
        if best is None or best[0] <= 1e-12:
            self.nodes[node_id] = ("leaf", float(y.mean()))
            return node_id
        _, f, thr, m = best
        left = self._build(X[m], y[m], depth + 1)
        right = self._build(X[~m], y[~m], depth + 1)
        self.nodes[node_id] = (int(f), float(thr), left, right)
        return node_id

    def fit(self, X, y):
        self.nodes = []
        self._build(np.asarray(X, float), np.asarray(y, float), 0)
        return self

    def predict(self, X):
        X = np.asarray(X, float)
        out = np.empty(X.shape[0])
        for i, x in enumerate(X):
            n = 0
            while True:
                node = self.nodes[n]
                if node[0] == "leaf":
                    out[i] = node[1]
                    break
                f, thr, l, r = node
                n = l if x[f] <= thr else r
        return out


class _Forest:
    def __init__(self, n_trees=40, max_depth=6, rng=None):
        self.rng = rng or np.random.default_rng(0)
        self.n_trees, self.max_depth = n_trees, max_depth
        self.trees: list[_Tree] = []

    def fit(self, X, y):
        X, y = np.asarray(X, float), np.asarray(y, float)
        n, d = X.shape
        self.trees = []
        for _ in range(self.n_trees):
            rows = self.rng.integers(0, n, n)  # bootstrap
            t = _Tree(self.max_depth, min_leaf=2,
                      n_feat=max(1, int(np.sqrt(d))), rng=self.rng)
            self.trees.append(t.fit(X[rows], y[rows]))
        return self

    def predict(self, X):
        return np.mean([t.predict(X) for t in self.trees], axis=0)


class _GBT:
    """Squared-loss gradient boosting (XGBoost-lite: shrinkage + depth cap)."""

    def __init__(self, n_rounds=60, depth=3, lr=0.15, rng=None):
        self.n_rounds, self.depth, self.lr = n_rounds, depth, lr
        self.rng = rng or np.random.default_rng(0)
        self.trees: list[_Tree] = []
        self.base = 0.0

    def fit(self, X, y):
        X, y = np.asarray(X, float), np.asarray(y, float)
        self.base = float(y.mean())
        pred = np.full_like(y, self.base)
        self.trees = []
        for _ in range(self.n_rounds):
            t = _Tree(self.depth, min_leaf=2, rng=self.rng).fit(X, y - pred)
            pred = pred + self.lr * t.predict(X)
            self.trees.append(t)
        return self

    def predict(self, X):
        p = np.full(np.asarray(X).shape[0], self.base)
        for t in self.trees:
            p = p + self.lr * t.predict(X)
        return p


class _KRR:
    """RBF kernel ridge regression — dual-form SVR stand-in."""

    def __init__(self, lam=1e-3, bandwidth=None):
        self.lam, self.bandwidth = lam, bandwidth

    def fit(self, X, y):
        X = np.asarray(X, float)
        self.X = X
        d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
        if self.bandwidth is None:
            off = d2[np.triu_indices(len(X), 1)]
            self.bandwidth = float(np.sqrt(np.median(off) + 1e-12)) or 1.0
        K = np.exp(-d2 / (2 * self.bandwidth**2))
        self.alpha = np.linalg.solve(K + self.lam * np.eye(len(X)), np.asarray(y, float))
        return self

    def predict(self, Xq):
        Xq = np.asarray(Xq, float)
        d2 = ((Xq[:, None, :] - self.X[None, :, :]) ** 2).sum(-1)
        return np.exp(-d2 / (2 * self.bandwidth**2)) @ self.alpha


class _PolyRidge:
    """HPCA'07-style regression: [x, x², top pairwise interactions], ridge."""

    def __init__(self, lam=1e-2):
        self.lam = lam

    def _phi(self, X):
        X = np.asarray(X, float)
        feats = [np.ones((X.shape[0], 1)), X, X**2]
        d = X.shape[1]
        pairs = [(i, j) for i in range(d) for j in range(i + 1, min(i + 4, d))]
        feats.append(np.stack([X[:, i] * X[:, j] for i, j in pairs], axis=1))
        return np.concatenate(feats, axis=1)

    def fit(self, X, y):
        P = self._phi(X)
        self.w = np.linalg.solve(P.T @ P + self.lam * np.eye(P.shape[1]),
                                 P.T @ np.asarray(y, float))
        return self

    def predict(self, Xq):
        return self._phi(Xq) @ self.w


# ------------------------------------------------------ surrogate + SA driver
def _sa_propose(models, pool_x, evaluated, rng, steps=300, t0=1.0) -> int:
    """Simulated annealing over pool rows; energy = Chebyshev-scalarized
    surrogate prediction (random weights per call), minimized."""
    N = pool_x.shape[0]
    preds = np.stack([m.predict(pool_x) for m in models], axis=1)  # [N, m]
    lo, hi = preds.min(0), preds.max(0)
    z = (preds - lo) / np.maximum(hi - lo, 1e-12)
    w = rng.dirichlet(np.ones(preds.shape[1]))
    energy = np.max(z * w[None, :], axis=1)  # Chebyshev
    taken = np.zeros(N, bool)
    taken[list(evaluated)] = True
    cur = int(rng.integers(N))
    best, best_e = cur, energy[cur] + (10.0 if taken[cur] else 0.0)
    for s in range(steps):
        nxt = int(rng.integers(N))
        temp = t0 * (1.0 - s / steps) + 1e-3
        e_cur = energy[cur] + (10.0 if taken[cur] else 0.0)
        e_nxt = energy[nxt] + (10.0 if taken[nxt] else 0.0)
        if e_nxt < e_cur or rng.random() < np.exp(-(e_nxt - e_cur) / temp):
            cur = nxt
            if e_nxt < best_e:
                best, best_e = nxt, e_nxt
    if taken[best]:  # all SA visits were evaluated points — fall back
        free = np.flatnonzero(~taken)
        best = int(free[np.argmin(energy[free])]) if free.size else best
    return best


# ------------------------------------------------------------- EHVI (microal)
def _ehvi_scores(state, pool_x, front_y, rows_taken, rng, dev, n_cand=64,
                 n_mc=8):
    """MC Expected HyperVolume Improvement over a candidate subset: the GP
    posterior on ``dev``, ``1 + n_cand·n_mc`` hypervolumes."""
    N = pool_x.shape[0]
    cand = rng.choice(N, size=min(n_cand, N), replace=False)
    cand = np.asarray([c for c in cand if c not in rows_taken], dtype=int)
    mean, std = gp_predict(state, torch.as_tensor(pool_x[cand], device=dev))
    mean, std = mean.cpu().numpy(), std.cpu().numpy()
    ref = front_y.max(axis=0) * 1.1 + 1e-9
    hv0 = hypervolume(front_y, ref, device=dev)
    scores = np.zeros(len(cand))
    for i in range(len(cand)):
        samp = mean[i] + std[i] * rng.standard_normal((n_mc, mean.shape[1]))
        gains = [max(0.0, hypervolume(np.vstack([front_y, s[None]]), ref,
                                      device=dev) - hv0)
                 for s in samp]
        scores[i] = float(np.mean(gains))
    return cand, scores


# ----------------------------------------------------------------- main loop
def run_baseline(
    name: str,
    space: DesignSpace,
    pool_idx: np.ndarray,
    flow: FlowFn,
    *,
    T: int = 40,
    b: int = 20,
    reference_front: np.ndarray | None = None,
    draws: TunerDraws | None = None,
    device=None,
    verbose: bool = False,
) -> TunerResult:
    """Run baseline ``name`` (one of :data:`BASELINES`) with SoC-Tuner's
    evaluation budget. ``draws`` supplies the numpy generator's seed
    (default: ``GeneratorDraws(0, device)``);
    fronts, ``microal``'s TED and GP run on ``device`` (default ``cuda``;
    the CPU only when asked for)."""
    if name not in BASELINES:
        raise ValueError(f"unknown baseline {name!r}")
    t0 = time.time()
    dev = resolve_device(device)
    draws = GeneratorDraws(0, dev) if draws is None else draws
    rng = np.random.default_rng(draws.baseline_seed())
    pool_idx = np.asarray(pool_idx)
    N = pool_idx.shape[0]
    pool_x = space.encode(torch.tensor(pool_idx)).numpy().astype(np.float64)

    # --- init set
    if name == "microal":  # TED init, plain space (no ICD importance)
        init = ted_select(torch.as_tensor(pool_x, dtype=torch.float32,
                                          device=dev), b=b, mu=0.1)
        init = list(dict.fromkeys(int(r) for r in init))
    else:
        init = list(rng.choice(N, size=b, replace=False))
    evaluated = list(init)
    y = np.asarray(flow(pool_idx[np.asarray(evaluated)]))

    history: list[dict] = []

    def log_round(i):
        front = front_mask(y, dev)
        rec = {"round": i, "evaluations": len(evaluated),
               "pareto_size": int(front.sum())}
        if reference_front is not None:
            rec["adrs"] = adrs(reference_front, y[front])
        history.append(rec)
        if verbose:
            print(f"[{name}] round {i:3d} evals={rec['evaluations']:4d}"
                  + (f" adrs={rec['adrs']:.4f}" if "adrs" in rec else ""))

    log_round(0)

    surrogate_factories = {
        "xgb": lambda: _GBT(rng=rng),
        "rf": lambda: _Forest(rng=rng),
        "svr": lambda: _KRR(),
        "regression": lambda: _PolyRidge(),
    }

    for it in range(T):
        taken = set(evaluated)
        if name == "random":
            free = np.asarray([i for i in range(N) if i not in taken])
            nxt = int(rng.choice(free))
        elif name in surrogate_factories:
            models = []
            for j in range(y.shape[1]):
                models.append(surrogate_factories[name]().fit(
                    pool_x[np.asarray(evaluated)], y[:, j]))
            nxt = _sa_propose(models, pool_x, taken, rng)
        else:  # microal: a cold GP fit, EHVI over a random candidate subset
            state = fit_gp(torch.as_tensor(pool_x[np.asarray(evaluated)],
                                           dtype=torch.float32, device=dev),
                           torch.as_tensor(y, dtype=torch.float32, device=dev),
                           steps=120)
            front = front_mask(y, dev)
            cand, scores = _ehvi_scores(state, pool_x.astype(np.float32),
                                        y[front], taken, rng, dev)
            nxt = int(cand[np.argmax(scores)]) if len(cand) else int(rng.integers(N))
        evaluated.append(nxt)
        y = np.concatenate([y, np.asarray(flow(pool_idx[nxt][None, :]))], axis=0)
        log_round(it + 1)

    front = front_mask(y, dev)
    rows = np.asarray(evaluated)
    return TunerResult(
        space=space, v=np.zeros(space.d), evaluated_rows=rows, y=y,
        pareto_rows=rows[front], pareto_y=y[front], history=history,
        wall_s=time.time() - t0)
