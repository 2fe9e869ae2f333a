"""Copy of the JAX package's ``utils/logging.py`` (no jax in it); the port keeps
its own copy so that it imports nothing from the JAX package.

Structured training-metrics sinks.

The reference's observability is stdout prints + a metrics.csv
(train.py:249-271, 634-642) — both replicated by the Trainer. This module
adds the modern sinks the reference lacks (SURVEY §5.5 "No
tensorboard/wandb"):

* ``JsonlSink`` — one JSON object per epoch in ``metrics.jsonl`` (greppable,
  machine-readable, append-only so it survives resume);
* ``TensorBoardSink`` — ``tf.summary`` event files when TensorFlow is
  importable, silently unavailable otherwise.

Both are optional and off the hot path (host-side, once per epoch).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

__all__ = ["MetricsLogger", "tensorboard_available"]


def tensorboard_available() -> bool:
    try:
        import tensorflow  # noqa: F401

        return True
    except Exception:
        return False


class MetricsLogger:
    """Fan-out logger: jsonl always, tensorboard when requested+available."""

    def __init__(self, log_dir: str, tensorboard: bool = False):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._tb = None
        if tensorboard and tensorboard_available():
            import tensorflow as tf

            self._tb = tf.summary.create_file_writer(
                os.path.join(log_dir, "tb")
            )

    def log(self, step: int, scalars: Dict[str, float],
            prefix: Optional[str] = None) -> None:
        flat = {
            (f"{prefix}/{k}" if prefix else k): float(v)
            for k, v in scalars.items()
        }
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps({"step": int(step), **flat}) + "\n")
        if self._tb is not None:
            import tensorflow as tf

            with self._tb.as_default(step=int(step)):
                for k, v in flat.items():
                    tf.summary.scalar(k, v)
            self._tb.flush()

    def truncate_after(self, step: int) -> None:
        """Resume support: drop jsonl rows beyond the checkpointed epoch."""
        if not os.path.exists(self.jsonl_path):
            return
        with open(self.jsonl_path) as f:
            rows = [ln for ln in f if ln.strip()]
        kept = [ln for ln in rows if json.loads(ln).get("step", 0) <= step]
        with open(self.jsonl_path, "w") as f:
            f.writelines(kept)
