"""Segmentation metrics from confusion matrices; counterpart of the JAX
package's ``metrics/segmentation.py`` (the reference's torchmetrics
wrappers, performance_metrics.py:52-141), with the same conventions:

* predictions and targets are first-max one-hot class maps; ``-1`` target
  pixels are zeroed in both before scoring;
* level 0: plain per-class metrics over its C classes (an all-zero row
  counts as class 0, as the reference's argmax makes it);
* levels >= 1: a synthetic background channel (``sum(channels) == 0``) is
  prepended, target==background pixels are ignored, and the background
  row is dropped at metric time;
* per-class "accuracy" is recall, and a class with a zero denominator
  scores 0.

The confusion matrices are exact int64 counts: a ``bincount`` of one joint
index per pixel (target class * C' + predicted class), unscored pixels sent
to one extra bin that is dropped (boolean indexing would make the host wait
for the device once more; an ``index_add_`` into 25 bins is slow on the
card, every thread adding into the same few words).
:func:`metrics_from_confusion` and :class:`MetricAccumulator` are host-side
numpy, copied from the JAX module.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["classmaps_from_outputs", "level_onehots",
           "level_confusion_matrices", "metrics_from_confusion",
           "MetricAccumulator"]


def _first_max_onehot(x: torch.Tensor) -> torch.Tensor:
    """``one_hot(argmax(x, -1))`` with the FIRST maximum on ties, as f32
    (``torch.argmax`` returns the first; a cumsum over the short channel
    axis, the JAX formulation, is a slow scan on the card)."""
    return F.one_hot(x.argmax(dim=-1), x.shape[-1]).float()


def level_onehots(outputs_per_level: Sequence[torch.Tensor],
                  targets_per_level: Sequence[torch.Tensor]) -> List[tuple]:
    """Per level ``(pred_oh, target_oh, valid, num_classes, child)``:
    exact one-hot rows (B, H, W, C') of the scored prediction and target,
    and the (B, H, W) pixels scored."""
    out = []
    for L, (o, t) in enumerate(zip(outputs_per_level, targets_per_level)):
        child = L > 0
        masked = t == -1.0
        pred_oh = torch.where(masked, 0.0, _first_max_onehot(o))
        t_m = torch.where(masked, 0.0, t.float())
        # all-zero rows (fully masked pixel, no positive class) are class 0
        # in the reference's argmax; synthesize that explicitly
        pred_bg = (pred_oh.sum(-1, keepdim=True) == 0).float()
        t_bg = (t_m.sum(-1, keepdim=True) == 0).float()
        if child:
            pred_oh = torch.cat([pred_bg, pred_oh], -1)
            t_aug = torch.cat([t_bg, t_m], -1)
            valid = t_bg[..., 0] == 0.0   # ignore_index=0
        else:
            pred_oh = torch.cat([pred_oh[..., :1] + pred_bg, pred_oh[..., 1:]],
                                -1)
            t_aug = torch.cat([t_m[..., :1] + t_bg, t_m[..., 1:]], -1)
            valid = torch.ones(t.shape[:-1], dtype=torch.bool,
                               device=t.device)
        # multi-hot targets (augmentation boundaries): the first positive
        # channel wins, as the reference's argmax
        t_oh = _first_max_onehot(t_aug)
        out.append((pred_oh, t_oh, valid, pred_oh.shape[-1], child))
    return out


def classmaps_from_outputs(outputs_per_level: Sequence[torch.Tensor],
                           targets_per_level: Sequence[torch.Tensor]
                           ) -> List[tuple]:
    """Per level ``(pred_map, target_map, num_classes_with_bg, child)``:
    the index-map view of :func:`level_onehots`."""
    return [(p_oh.argmax(-1), t_oh.argmax(-1), c, child)
            for p_oh, t_oh, _, c, child in level_onehots(outputs_per_level,
                                                          targets_per_level)]


def level_confusion_matrices(outputs_per_level: Sequence[torch.Tensor],
                             targets_per_level: Sequence[torch.Tensor],
                             per_image: bool = False) -> List[torch.Tensor]:
    """Per-level (C', C') int64 confusion matrices (target row, predicted
    column); (B, C', C') with ``per_image``. Child levels keep the
    background row and column (dropped at metric time)."""
    mats = []
    for p_oh, t_oh, valid, c, _ in level_onehots(outputs_per_level,
                                                 targets_per_level):
        b = p_oh.shape[0] if per_image else 1
        # rows are exact one-hots, so argmax is the class index; image i
        # owns cells [i*c*c, (i+1)*c*c) with per_image
        q = (t_oh.argmax(-1) * c + p_oh.argmax(-1)).reshape(b, -1)
        q = q + torch.arange(b, device=q.device)[:, None] * (c * c)
        trash = b * c * c
        q = torch.where(valid.reshape(b, -1), q, trash).reshape(-1)
        cm = torch.bincount(q, minlength=trash + 1)[:trash].reshape(b, c, c)
        mats.append(cm if per_image else cm[0])
    return mats


def metrics_from_confusion(confmat: np.ndarray,
                           child: bool) -> Dict[str, np.ndarray]:
    """Per-class metrics from one confusion matrix (host-side numpy)."""
    confmat = np.asarray(confmat, np.float64)
    tp = np.diag(confmat)
    support = confmat.sum(1)
    predicted = confmat.sum(0)
    fn = support - tp
    fp = predicted - tp

    def safe(n, d):
        return np.where(d > 0, n / np.maximum(d, 1), 0.0)

    m = {
        "accuracy": safe(tp, support),  # torchmetrics per-class acc == recall
        "iou": safe(tp, tp + fp + fn),
        "dice": safe(2 * tp, 2 * tp + fp + fn),
        "precision": safe(tp, tp + fp),
        "recall": safe(tp, support),
    }
    if child:  # drop synthesized background (performance_metrics.py:63)
        m = {k: v[1:] for k, v in m.items()}
    return m


class MetricAccumulator:
    """Host-side epoch aggregator with the reference's bookkeeping shape:
    per-class running lists, batch-mean epoch values, and ``perf_no_bg``."""

    KEYS = ("accuracy", "iou", "dice", "precision", "recall")

    def __init__(self, num_classes_per_level: Sequence[int]):
        self.num_classes_per_level = tuple(num_classes_per_level)
        self.total = int(sum(num_classes_per_level))
        self.per_class: List[Dict[str, List[float]]] = [
            {k: [] for k in self.KEYS} for _ in range(self.total)
        ]
        self.overall: Dict[str, List[float]] = {k: [] for k in self.KEYS}
        self.perf_no_bg: List[float] = []

    def update(self, confmats: Sequence[np.ndarray]) -> float:
        """Add one batch. Returns this batch's perf_no_bg (mean dice sans bg)."""
        per_level = [
            metrics_from_confusion(np.asarray(cm), child=L > 0)
            for L, cm in enumerate(confmats)
        ]
        cat = {
            k: np.concatenate([m[k] for m in per_level]) for k in self.KEYS
        }
        assert len(cat["dice"]) == self.total
        for k in self.KEYS:
            self.overall[k].append(float(np.mean(cat[k])))
            for c in range(self.total):
                self.per_class[c][k].append(float(cat[k][c]))
        pnb = float(np.mean(cat["dice"][1:]))  # train.py:53
        self.perf_no_bg.append(pnb)
        return pnb

    # ------------------------------------------------------------- summaries
    def epoch_overall(self) -> Dict[str, float]:
        return {k: float(np.mean(v)) if v else 0.0 for k, v in self.overall.items()}

    def epoch_per_class(self) -> List[Dict[str, float]]:
        return [
            {k: float(np.mean(v)) if v else 0.0 for k, v in c.items()}
            for c in self.per_class
        ]

    def selection_metric(self) -> tuple:
        """(mean, std) of per-batch perf_no_bg — the best-checkpoint criterion
        (train.py:345, 664)."""
        if not self.perf_no_bg:
            return 0.0, 0.0
        return float(np.mean(self.perf_no_bg)), float(np.std(self.perf_no_bg))
