"""Training loops."""

from fsrl_torch.trainer.trainer import (BaseTrainer, OnpolicyTrainer,
                                       perf_is_better)

__all__ = ["BaseTrainer", "OnpolicyTrainer", "perf_is_better"]
