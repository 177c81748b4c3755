"""QT-Opt optimizer construction over the port's optimizers.

Port of tensor2robot_tpu/research/qtopt/optimizer_builder.py: a staircase
exponential-decay learning rate stepped every examples_per_epoch /
batch_size * num_epochs_per_decay updates, then momentum | rmsprop | adam
(models/optimizers.py, whose updates are optax's). The moving-average
parameters are the trainer's EMA (`use_avg_model_params` on the model).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tensor2robot_tpu_torch.models import optimizers


@dataclasses.dataclass
class QtOptHParams:
    """The hyperparameter bundle of BuildOpt."""

    batch_size: int = 32
    examples_per_epoch: int = 3_000_000
    learning_rate: float = 1e-4
    learning_rate_decay_factor: float = 0.999
    model_weights_averaging: float = 0.9999
    momentum: float = 0.9
    num_epochs_per_decay: float = 2.0
    optimizer: str = "momentum"
    rmsprop_decay: float = 0.9
    rmsprop_epsilon: float = 1.0
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    use_avg_model_params: bool = True


def build_learning_rate(hparams: QtOptHParams) -> optimizers.Schedule:
    """Staircase exponential decay of the update count."""
    decay_steps = int(
        hparams.examples_per_epoch / hparams.batch_size
        * hparams.num_epochs_per_decay
    )
    return optimizers.create_exponential_decay_learning_rate(
        initial_learning_rate=hparams.learning_rate,
        decay_steps=max(decay_steps, 1),
        decay_rate=hparams.learning_rate_decay_factor,
        staircase=True,
    )


def build_opt(hparams: Optional[QtOptHParams] = None) -> optimizers.OptimizerFactory:
    """The QT-Opt optimizer factory; the descent rule only (the trainer
    keeps the EMA)."""
    hparams = hparams or QtOptHParams()
    learning_rate = build_learning_rate(hparams)
    if hparams.optimizer == "momentum":
        return optimizers.create_momentum_optimizer(
            learning_rate, momentum=hparams.momentum)
    if hparams.optimizer == "rmsprop":
        return optimizers.create_rms_prop_optimizer(
            learning_rate, decay=hparams.rmsprop_decay,
            momentum=hparams.momentum, epsilon=hparams.rmsprop_epsilon,
        )
    if hparams.optimizer == "adam":
        return optimizers.create_adam_optimizer(
            learning_rate, beta1=hparams.momentum, beta2=hparams.adam_beta2,
            epsilon=hparams.adam_epsilon,
        )
    raise ValueError(
        f"Unknown optimizer {hparams.optimizer!r}; expected one of "
        "'momentum', 'rmsprop', 'adam'."
    )
