"""Serving substrate: batched prefill + decode engine."""
from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
