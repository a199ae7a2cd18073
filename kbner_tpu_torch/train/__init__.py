from .optim import (ReduceLROnPlateau, inverse_sqrt_schedule,
                    linear_warmup_linear_decay, make_finetune_optimizer)
from .trainer import FinetuneTrainer, TrainConfig

__all__ = ["FinetuneTrainer", "TrainConfig", "make_finetune_optimizer",
           "linear_warmup_linear_decay", "inverse_sqrt_schedule",
           "ReduceLROnPlateau"]
