"""SoC-Tuner core on PyTorch: Algorithm 3 for one scenario and for a fleet.

- ``space``       TABLE I design space (encode/sample/prune)
- ``icd``         Algorithm 1 — inter-cluster-distance importance
- ``sampling``    Algorithm 2 — importance-guided TED initialization
- ``gp``          GP surrogates (Eqs. 3-4), objectives as a batch dimension
- ``acquisition`` IMOO information-gain acquisition (Eqs. 5-10)
- ``engine``      ``BOEngine`` (one scenario) and ``BatchedBOEngine`` (a fleet)
- ``tuner``       Algorithm 3 — the full exploration loop
- ``fleet``       Algorithm 3 over a fleet of scenarios, one batched engine
- ``propose``     the between-round proposer (new designs near the front)
- ``pareto``      dominance / Pareto front / ADRS (Eq. 12) / hypervolume /
                  nondominated sort
- ``baselines``   the six comparison methods of §IV (``run_baseline``)

Explore one scenario::

    import torch
    from repro_torch.core import make_space, pareto_front, soc_tuner
    from repro_torch.soc import VLSIFlow

    space = make_space()
    gen = torch.Generator(device="cuda").manual_seed(0)
    pool = space.sample(gen, 500).cpu().numpy()
    flow = VLSIFlow(space, "resnet50")
    res = soc_tuner(space, pool, flow, T=15, n=20, b=12, seed=0)
    print(res.pareto_y)
"""
from .space import DesignSpace, Feature, TABLE_I, make_space
from .icd import icd, icd_from_data
from .pareto import (adrs, dominance_counts, hypervolume, nondominated_sort,
                     pareto_front, pareto_mask)
from .sampling import soc_init, ted_select, transform_to_icd
from .gp import (GPParams, GPState, fit_gp, fit_gp_batch, gp_joint_samples,
                 gp_predict, pad_training)
from .acquisition import (frontier_maxima, imoo_scores, imoo_scores_batch,
                          mes_information_gain)
from .engine import BatchedBOEngine, BOEngine, EngineStats
from .tuner import TunerResult, explore_prologue, soc_tuner
from .propose import ProposerConfig, ProposerStats
from .fleet import (FleetResult, FleetScenario, FlowEvalCache, fleet_prologue,
                    fleet_tuner)
from .baselines import BASELINES, run_baseline

__all__ = [
    "DesignSpace", "Feature", "TABLE_I", "make_space",
    "icd", "icd_from_data",
    "adrs", "dominance_counts", "hypervolume", "nondominated_sort",
    "pareto_front", "pareto_mask",
    "soc_init", "ted_select", "transform_to_icd",
    "GPParams", "GPState", "fit_gp", "fit_gp_batch", "gp_joint_samples",
    "gp_predict", "pad_training",
    "frontier_maxima", "imoo_scores", "imoo_scores_batch",
    "mes_information_gain",
    "BOEngine", "BatchedBOEngine", "EngineStats",
    "TunerResult", "explore_prologue", "soc_tuner",
    "ProposerConfig", "ProposerStats",
    "FleetResult", "FleetScenario", "FlowEvalCache", "fleet_prologue",
    "fleet_tuner",
    "BASELINES", "run_baseline",
]
