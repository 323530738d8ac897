"""Training loops."""

from fsrl_torch.trainer.trainer import (BaseTrainer, OffpolicyTrainer,
                                       OnpolicyTrainer, perf_is_better)

__all__ = ["BaseTrainer", "OffpolicyTrainer", "OnpolicyTrainer",
           "perf_is_better"]
