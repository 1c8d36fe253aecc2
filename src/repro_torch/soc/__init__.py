"""SoC evaluation substrate — the VLSI-flow stand-in."""
from .flow import DelayedFlow, VLSIFlow
from .model import (CONST, FEATI, decode_design, metrics_multi, metrics_tile,
                    soc_metrics_multi)
from .workloads import WORKLOADS, get_workload, pad_workloads

__all__ = ["VLSIFlow", "DelayedFlow", "CONST", "FEATI", "decode_design",
           "metrics_tile", "metrics_multi", "soc_metrics_multi", "WORKLOADS",
           "get_workload", "pad_workloads"]
