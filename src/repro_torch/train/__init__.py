"""Training on one device: AdamW with float32 masters, the synthetic
bigram data, checkpoints, the train step and the fault-tolerant loop
(``repro.train`` on PyTorch; the ZeRO-1 specs wait for ``parallel/``)."""
from .optimizer import (LRSchedule, TrainState, adamw_init, adamw_update,
                        cosine_lr)
from .data import DataConfig, bigram_entropy, make_batch
from .checkpoint import AsyncCheckpointer, latest_step, restore, save
from .loop import TrainConfig, init_params, make_train_step, train

__all__ = [
    "TrainState", "adamw_init", "adamw_update", "cosine_lr", "LRSchedule",
    "DataConfig", "make_batch", "bigram_entropy",
    "AsyncCheckpointer", "latest_step", "restore", "save",
    "TrainConfig", "make_train_step", "train", "init_params",
]
