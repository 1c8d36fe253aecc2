"""SoC evaluation substrate — the VLSI-flow stand-in."""
from .flow import DelayedFlow, SimplifiedFlow, VLSIFlow
from .model import (CONST, FEATI, area_breakdown, decode_design,
                    metrics_multi, metrics_tile, soc_metrics_multi)
from .simplified import simplified_metrics
from .workloads import WORKLOADS, get_workload, pad_workloads

__all__ = ["VLSIFlow", "SimplifiedFlow", "DelayedFlow", "CONST", "FEATI",
           "area_breakdown", "decode_design", "metrics_tile", "metrics_multi",
           "soc_metrics_multi", "simplified_metrics", "WORKLOADS",
           "get_workload", "pad_workloads"]
