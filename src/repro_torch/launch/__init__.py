"""Launchers of the port: the production meshes (on CUDA devices, or over a
fake process group for the dry run), the train/serve CLIs, and the sharded
LM program's dry run (``specs``, ``dryrun``, ``program_stats``,
``roofline``)."""
from .mesh import make_mesh_named, make_production_mesh

__all__ = ["make_production_mesh", "make_mesh_named"]
