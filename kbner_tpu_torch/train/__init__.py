"""Trainers (fine-tuning and the parser and classifier families),
optimizers and schedules (the package surface of ``kbner_tpu.train``)."""
from .optim import (
    SGDW,
    ReduceLROnPlateau,
    exp_anneal_schedule,
    inverse_sqrt_schedule,
    linear_warmup_linear_decay,
    make_finetune_optimizer,
)
from .parser_trainer import (
    BiaffineNERTrainer,
    ClassificationTrainer,
    ParserTrainer,
    RegressionTrainer,
    SemDepTrainer,
)
from .trainer import FinetuneTrainer, TrainConfig

__all__ = [
    "FinetuneTrainer",
    "TrainConfig",
    "make_finetune_optimizer",
    "linear_warmup_linear_decay",
    "inverse_sqrt_schedule",
    "ReduceLROnPlateau",
    "SGDW",
    "exp_anneal_schedule",
    "ParserTrainer",
    "SemDepTrainer",
    "BiaffineNERTrainer",
    "ClassificationTrainer",
    "RegressionTrainer",
]
