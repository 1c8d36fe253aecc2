"""Distributed-optimization helpers of the port: int8 gradient compression
with error feedback (:mod:`.collectives`). Sharding rules and the mesh
(``repro.parallel.sharding``) wait for ROADMAP queue 1, item 14b.8."""
from .collectives import (QuantGrads, dequantize_tree, ef_update,
                          init_error_feedback, quantize_tree)

__all__ = ["QuantGrads", "quantize_tree", "dequantize_tree", "ef_update",
           "init_error_feedback"]
