"""Training in the port: the synthetic data, AdamW, the train loop and
checkpoints in the JAX package's format (the port of
``repro/training``)."""

from repro_torch.training import checkpoint, data, optimizer
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import OptimizerConfig, OptState
from repro_torch.training.train_loop import (Trainer, TrainerConfig,
                                             make_train_step)

__all__ = [
    "checkpoint", "data", "optimizer", "DataConfig", "SyntheticLM",
    "OptimizerConfig", "OptState", "Trainer", "TrainerConfig",
    "make_train_step",
]
