"""Evaluation metrics.

Counterpart of ``singa_tpu/metric.py``: ``Metric`` and top-k
``Accuracy`` over host copies of predictions and targets (integer class
ids or one-hot rows).
"""

from __future__ import annotations

import numpy as np

from .tensor import Tensor


def _np(x):
    if isinstance(x, Tensor):
        return x.to_numpy()
    return np.asarray(x)


class Metric:
    """Base metric."""

    def forward(self, prediction, target):
        """Per-sample scores as a float array."""
        raise NotImplementedError

    def evaluate(self, prediction, target):
        """Mean score over the batch."""
        return float(np.mean(self.forward(prediction, target)))

    # C++-style aliases; delegate so subclass overrides dispatch correctly
    def Forward(self, prediction, target):
        return self.forward(prediction, target)

    def Evaluate(self, prediction, target):
        return self.evaluate(prediction, target)


class Accuracy(Metric):
    """Top-k accuracy; ``target`` may be integer class ids or one-hot
    rows."""

    def __init__(self, top_k=1):
        self.top_k = top_k

    def forward(self, prediction, target):
        pred = _np(prediction)
        tgt = _np(target)
        if tgt.shape == pred.shape:
            tgt = np.argmax(tgt, axis=-1)        # one-hot rows
        tgt = tgt.astype(np.int64).ravel()
        pred2d = pred.reshape(-1, pred.shape[-1])
        if self.top_k == 1:
            return (np.argmax(pred2d, axis=-1) == tgt).astype(np.float32)
        topk = np.argsort(-pred2d, axis=-1)[:, :self.top_k]
        return np.any(topk == tgt[:, None], axis=-1).astype(np.float32)


def accuracy(pred, target):
    """Batch accuracy as a float."""
    return Accuracy().evaluate(pred, target)
