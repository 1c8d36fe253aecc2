"""Launchers of the port: the production meshes and the train/serve CLIs."""
from .mesh import make_mesh_named, make_production_mesh

__all__ = ["make_production_mesh", "make_mesh_named"]
