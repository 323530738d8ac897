"""Training loops."""

from fsrl_torch.trainer.host_trainer import (HostOffpolicyTrainer,
                                            HostOnpolicyTrainer)
from fsrl_torch.trainer.trainer import (BaseTrainer, OffpolicyTrainer,
                                       OnpolicyTrainer, offpolicy_trainer,
                                       onpolicy_trainer, perf_is_better)

__all__ = ["BaseTrainer", "HostOffpolicyTrainer", "HostOnpolicyTrainer",
           "OffpolicyTrainer", "OnpolicyTrainer", "offpolicy_trainer",
           "onpolicy_trainer", "perf_is_better"]
