"""CTR evaluation metrics: AUC, Log Loss, F1 (paper section 5.1) and the
mergeable streaming accumulators of online evaluation; numpy copy of
``repro.core.metrics``."""
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


# ---------------------------------------------------------------------------
# streaming / mergeable accumulators (online eval; docs/streaming.md)
# ---------------------------------------------------------------------------

class StreamingAUC:
    """Fixed-bin histogram AUC with an ``update`` / ``merge`` / ``value`` API.

    Scores are bucketed into ``n_bins`` equal-width bins over [lo, hi]
    (CTR scores are probabilities, so the default [0, 1] loses nothing);
    per-class counts are all the state, so accumulators from different
    hosts / eval windows merge by addition. ``value`` is the Mann-Whitney
    statistic with in-bin ties counted half — it converges to the exact
    ``auc`` as bins shrink (≤1e-3 off at the default 4096 bins on 10k
    scores; tests/test_stream.py).
    """

    def __init__(self, n_bins: int = 4096, lo: float = 0.0, hi: float = 1.0):
        assert n_bins > 0 and hi > lo
        self.n_bins = n_bins
        self.lo = lo
        self.hi = hi
        self.pos = np.zeros((n_bins,), np.int64)
        self.neg = np.zeros((n_bins,), np.int64)

    def update(self, labels, scores) -> "StreamingAUC":
        labels = np.asarray(labels).astype(np.int64).ravel()
        scores = np.asarray(scores, dtype=np.float64).ravel()
        idx = ((scores - self.lo) / (self.hi - self.lo) * self.n_bins)
        idx = np.clip(idx.astype(np.int64), 0, self.n_bins - 1)
        self.pos += np.bincount(idx[labels == 1], minlength=self.n_bins)
        self.neg += np.bincount(idx[labels != 1], minlength=self.n_bins)
        return self

    def merge(self, other: "StreamingAUC") -> "StreamingAUC":
        assert (self.n_bins, self.lo, self.hi) == \
            (other.n_bins, other.lo, other.hi), "bin layouts differ"
        self.pos += other.pos
        self.neg += other.neg
        return self

    @property
    def n(self) -> int:
        return int(self.pos.sum() + self.neg.sum())

    def value(self) -> float:
        n_pos = int(self.pos.sum())
        n_neg = int(self.neg.sum())
        if n_pos == 0 or n_neg == 0:
            return 0.5
        neg_below = np.cumsum(self.neg) - self.neg      # strictly lower bins
        correct = (self.pos * neg_below).sum() + 0.5 * (self.pos * self.neg).sum()
        return float(correct / (n_pos * n_neg))


class StreamingLogLoss:
    """Running-mean log loss; exact (a sum and a count), trivially mergeable."""

    def __init__(self, eps: float = 1e-7):
        self.eps = eps
        self.total = 0.0
        self.n = 0

    def update(self, labels, scores) -> "StreamingLogLoss":
        labels = np.asarray(labels, dtype=np.float64).ravel()
        p = np.clip(np.asarray(scores, dtype=np.float64).ravel(),
                    self.eps, 1 - self.eps)
        self.total += float(-np.sum(labels * np.log(p)
                                    + (1 - labels) * np.log(1 - p)))
        self.n += labels.size
        return self

    def merge(self, other: "StreamingLogLoss") -> "StreamingLogLoss":
        self.total += other.total
        self.n += other.n
        return self

    def value(self) -> float:
        return self.total / max(self.n, 1)


__all__ = ["auc", "log_loss", "f1", "ctr_metrics", "StreamingAUC",
           "StreamingLogLoss"]
