"""SoC evaluation substrate — the VLSI-flow stand-in."""
from .flow import VLSIFlow
from .model import CONST, FEATI, decode_design, metrics_tile
from .workloads import WORKLOADS, get_workload

__all__ = ["VLSIFlow", "CONST", "FEATI", "decode_design", "metrics_tile",
           "WORKLOADS", "get_workload"]
