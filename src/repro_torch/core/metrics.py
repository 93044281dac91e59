"""CTR evaluation metrics: AUC, Log Loss, F1 (paper section 5.1); numpy
copy of ``repro.core.metrics``. The streaming accumulators wait for the
streaming slice."""
from __future__ import annotations

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC with tie handling via average ranks."""
    labels = np.asarray(labels).astype(np.int64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(scores, kind="mergesort")
    s_sorted = scores[order]
    ranks = np.empty_like(s_sorted)
    i = 0
    r = 1.0
    while i < s_sorted.size:
        j = i
        while j + 1 < s_sorted.size and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        ranks[i:j + 1] = (r + r + (j - i)) / 2.0
        r += j - i + 1
        i = j + 1
    rank_of = np.empty_like(ranks)
    rank_of[order] = ranks
    sum_pos = rank_of[labels == 1].sum()
    return float((sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def log_loss(labels: np.ndarray, scores: np.ndarray,
             eps: float = 1e-7) -> float:
    labels = np.asarray(labels, dtype=np.float64).ravel()
    p = np.clip(np.asarray(scores, dtype=np.float64).ravel(), eps, 1 - eps)
    return float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))


def f1(labels: np.ndarray, scores: np.ndarray,
       threshold: float = 0.5) -> float:
    labels = np.asarray(labels).astype(np.int64).ravel()
    pred = (np.asarray(scores).ravel() >= threshold).astype(np.int64)
    tp = int(np.sum((pred == 1) & (labels == 1)))
    fp = int(np.sum((pred == 1) & (labels == 0)))
    fn = int(np.sum((pred == 0) & (labels == 1)))
    if tp == 0:
        return 0.0
    prec = tp / (tp + fp)
    rec = tp / (tp + fn)
    return float(2 * prec * rec / (prec + rec))


def ctr_metrics(labels, scores) -> dict:
    return {"auc": auc(labels, scores), "log_loss": log_loss(labels, scores),
            "f1": f1(labels, scores)}


__all__ = ["auc", "log_loss", "f1", "ctr_metrics"]
