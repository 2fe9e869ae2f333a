"""Copy of the JAX package's ``train/plateau.py`` (no jax in it); the port keeps
its own copy so that it imports nothing from the JAX package.

ReduceLROnPlateau — host-side replica of torch's scheduler as configured by
the reference (train.py:603-611: mode='max', factor=0.5, patience=3, min_lr).

torch semantics replicated: rel threshold 1e-4 (better means
``metric > best * (1 + 1e-4)`` for mode max), ``num_bad_epochs > patience``
triggers ``lr = max(lr * factor, min_lr)`` and resets the bad-epoch counter.
"""
from __future__ import annotations

__all__ = ["ReduceLROnPlateau"]


class ReduceLROnPlateau:
    def __init__(
        self,
        lr: float,
        mode: str = "max",
        factor: float = 0.5,
        patience: int = 3,
        threshold: float = 1e-4,
        min_lr: float = 0.0,
    ):
        assert mode in ("max", "min")
        self.lr = float(lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = None
        self.num_bad_epochs = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def step(self, metric: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) LR."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return {
            "lr": self.lr,
            "best": self.best,
            "num_bad_epochs": self.num_bad_epochs,
        }

    def load_state_dict(self, d: dict) -> None:
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]
