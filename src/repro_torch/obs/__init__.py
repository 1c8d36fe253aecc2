"""Observability of the exploration drivers (progress records)."""
from .progress import log_progress

__all__ = ["log_progress"]
