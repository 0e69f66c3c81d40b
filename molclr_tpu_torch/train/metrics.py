"""Evaluation metrics and label normalization.

ROC-AUC is computed by the Mann-Whitney rank statistic with tie averaging
(equivalent to sklearn.roc_auc_score, which the reference calls at
finetune.py:315,379). Following the reference, classification scores are the
raw class-1 logits (quirk Q7: no softmax — monotonicity makes AUC identical
for softmax of 2-logit pairs only when applied per-pair; kept as documented
behavior via score_mode).

Copied from molclr_tpu/train/metrics.py with its imports
rewritten to this package.
"""

from __future__ import annotations

import numpy as np


def _rankdata_average(x: np.ndarray) -> np.ndarray:
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    labels = np.asarray(labels).astype(int)
    scores = np.asarray(scores).astype(np.float64)
    pos = labels == 1
    n_pos = int(pos.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    r = _rankdata_average(scores)
    return float((r[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def rmse(labels: np.ndarray, preds: np.ndarray) -> float:
    d = np.asarray(preds, np.float64) - np.asarray(labels, np.float64)
    return float(np.sqrt(np.mean(d ** 2)))


def mae(labels: np.ndarray, preds: np.ndarray) -> float:
    d = np.asarray(preds, np.float64) - np.asarray(labels, np.float64)
    return float(np.mean(np.abs(d)))


METRICS = {"roc_auc": roc_auc, "rmse": rmse, "mae": mae}

# whether larger is better, for best-checkpoint gating
# (ref finetune.py:228-243)
METRIC_DIRECTION = {"roc_auc": 1, "rmse": -1, "mae": -1}


class Normalizer:
    """z-score label normalizer (ref finetune.py:38-58)."""

    def __init__(self, values: np.ndarray):
        values = np.asarray(values, np.float64)
        self.mean = float(values.mean())
        self.std = float(values.std())
        if self.std == 0:
            self.std = 1.0

    def norm(self, x):
        return (x - self.mean) / self.std

    def denorm(self, x):
        return x * self.std + self.mean
