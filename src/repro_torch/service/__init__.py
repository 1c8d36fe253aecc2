"""Exploration service pieces of the port: versioned, atomic snapshots
(:mod:`repro_torch.service.checkpoint`), which ``soc_tuner`` and
``fleet_tuner`` write with ``checkpoint_dir`` and read with ``resume``."""
from . import checkpoint

__all__ = ["checkpoint"]
