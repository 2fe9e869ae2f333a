"""Train state and optimizer; counterpart of the JAX package's
``train/state.py``.

The reference trains with ``torch.optim.AdamW(model.parameters(), lr)``
(train.py:513-516): betas (0.9, 0.999), eps 1e-8 and weight decay 0.01 on
every parameter. The JAX package builds the same update with optax
(``tests/test_train_steps.py:test_adamw_matches_torch_trajectory`` holds the
two together); the port uses torch's. The learning rate lives in the
optimizer's parameter groups, where the plateau scheduler sets it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

__all__ = ["TrainState", "make_optimizer", "create_train_state",
           "set_learning_rate"]


@dataclass
class TrainState:
    """What a train step reads and updates in place: the model (parameters
    and BatchNorm running buffers), its optimizer, and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, lr: float,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(model: nn.Module, lr: float,
                       weight_decay: float = 0.01) -> TrainState:
    """A state around ``model`` (already on its device, in its memory
    format) with a fresh AdamW over all its parameters."""
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), lr,
                                               weight_decay))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Set the learning rate of every parameter group (plateau scheduler)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state
