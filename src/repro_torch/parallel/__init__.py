"""Distributed-optimization helpers of the port: the logical-axis sharding
resolver, the port's mesh and ``constraint`` (:mod:`.sharding`), and int8
gradient compression with error feedback (:mod:`.collectives`).

``constraint`` is the reference's ``with_sharding_constraint`` by logical
axes: a ``torch.distributed.tensor`` redistribution of a DTensor to the
placements its resolved spec gives under ``axis_rules(mesh, ...)``, and the
identity without a mesh or on a plain tensor, so the model code runs the
sharded LM program and the one-device one unchanged.
"""
from .collectives import (QuantGrads, dequantize_tree, ef_update,
                          init_error_feedback, quantize_tree)
from .sharding import (DEFAULT_RULES, AxisRules, Mesh, NamedSharding, P,
                       axis_rules, constraint, current_rules, distribute,
                       named_sharding, resolve_spec, tree_specs)

__all__ = ["AxisRules", "Mesh", "NamedSharding", "P", "axis_rules",
           "current_rules", "named_sharding", "resolve_spec", "tree_specs",
           "constraint", "distribute",
           "DEFAULT_RULES", "QuantGrads", "quantize_tree", "dequantize_tree",
           "ef_update", "init_error_feedback"]
