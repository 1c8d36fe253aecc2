"""Distributed-optimization helpers of the port: the logical-axis sharding
resolver and the port's mesh (:mod:`.sharding`), and int8 gradient
compression with error feedback (:mod:`.collectives`).

The reference's ``constraint`` (``with_sharding_constraint`` by logical
axes inside GSPMD-compiled model code) is not here. Its counterpart is a
``torch.distributed.tensor`` redistribution of the sharded LM program
(ROADMAP queue 1, item 14b.9); until then the port's model code runs
unsharded, and nothing stands in for ``constraint`` under a mesh.
"""
from .collectives import (QuantGrads, dequantize_tree, ef_update,
                          init_error_feedback, quantize_tree)
from .sharding import (DEFAULT_RULES, AxisRules, Mesh, NamedSharding, P,
                       axis_rules, current_rules, named_sharding,
                       resolve_spec, tree_specs)

__all__ = ["AxisRules", "Mesh", "NamedSharding", "P", "axis_rules",
           "current_rules", "named_sharding", "resolve_spec", "tree_specs",
           "DEFAULT_RULES", "QuantGrads", "quantize_tree", "dequantize_tree",
           "ef_update", "init_error_feedback"]
