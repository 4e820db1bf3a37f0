"""Classifier eval metrics for the mel-eval backbones (VGGishish/Melception),
the port's own numpy/scipy copy of maa3_tpu/eval/metrics.py (the port
imports nothing of the JAX package).

Capability parity with ldm/modules/losses_audio/vggishish/metrics.py:11-56,
which the reference trainer logs each epoch: accuracy@k, one-vs-rest mean
average precision (mAP), mean ROC-AUC and d-prime. The reference delegates to
sklearn; here the estimators are pure numpy so the library has no sklearn
runtime dependency — tests/test_torch_eval.py holds them to the JAX
package's copy on random data.

Semantics matched exactly:
  * average_precision: sklearn's step-wise AP (sum (R_n - R_{n-1}) * P_n over
    descending unique scores), NOT the trapezoidal/interpolated variant.
  * roc_auc: Mann-Whitney U with midranks for tied scores.
  * the reference wraps roc_auc in try/except ValueError — if any class never
    occurs in targets it logs a warning and reports mAP=0, mROCAUC=0.5
    (metrics.py:44-48); `metrics()` reproduces that fallback.
  * dprime = norm.ppf(mROCAUC) * sqrt(2) (metrics.py:53) — the normal ppf is
    evaluated with scipy (in the baked-in image), matching the reference.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary AP = sum_n (R_n - R_{n-1}) P_n over descending score thresholds
    (sklearn.metrics.average_precision_score semantics, including tie
    handling by grouping equal scores into one threshold)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = y_true.sum()
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-y_score, kind="mergesort")
    y_true, y_score = y_true[order], y_score[order]
    # threshold boundaries: last index of each group of equal scores
    distinct = np.where(np.diff(y_score))[0]
    idx = np.r_[distinct, y_true.size - 1]
    tp = np.cumsum(y_true)[idx]
    fp = (idx + 1) - tp
    precision = tp / (tp + fp)
    recall = tp / n_pos
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Binary ROC-AUC via the rank statistic (midranks for ties). Raises
    ValueError when only one class is present — same contract as
    sklearn.metrics.roc_auc_score, which the reference's try/except keys on."""
    y_true = np.asarray(y_true).astype(bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = y_true.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true; "
                         "ROC AUC score is not defined in that case.")
    # midranks: average rank of each tie group
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(y_score.size, dtype=np.float64)
    sorted_scores = y_score[order]
    i = 0
    while i < sorted_scores.size:
        j = i
        while (j + 1 < sorted_scores.size
               and sorted_scores[j + 1] == sorted_scores[i]):
            j += 1
        ranks[order[i : j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[y_true].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def _softmax(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _norm_ppf(q: float) -> float:
    from scipy.stats import norm  # baked-in; reference uses the same
    return float(norm.ppf(q))


def metrics(targets: np.ndarray, outputs: np.ndarray,
            topk: Sequence[int] = (1, 5)) -> Dict[str, float]:
    """Reference `metrics(targets, outputs, topk)` (vggishish/metrics.py:11):
    targets (N,) int class ids, outputs (N, C) pre-softmax logits. Returns
    {accuracy_k..., mAP, mROCAUC, dprime}."""
    targets = np.asarray(targets).astype(np.int64)
    outputs = np.asarray(outputs, dtype=np.float64)
    n, num_cls = outputs.shape
    out: Dict[str, float] = {}

    kmax = max(topk)
    preds = np.argsort(-outputs, axis=1, kind="stable")[:, :kmax]
    correct = preds == targets[:, None]
    for k in topk:
        out[f"accuracy_{k}"] = float(correct[:, :k].sum() / n)

    onehot = np.eye(num_cls, dtype=np.int64)[targets]
    probs = _softmax(outputs)
    try:
        aucs = [roc_auc(onehot[:, c], probs[:, c]) for c in range(num_cls)]
        aps = [average_precision(onehot[:, c], probs[:, c])
               for c in range(num_cls)]
    except ValueError:
        # reference metrics.py:44-48: some class never occurs in targets
        logger.warning("Weird... Some classes never occured in targets. "
                       "Do not trust the metrics.")
        aucs = [0.5]
        aps = [0.0]
    out["mAP"] = float(np.mean(aps))
    out["mROCAUC"] = float(np.mean(aucs))
    out["dprime"] = _norm_ppf(out["mROCAUC"]) * float(np.sqrt(2.0))
    return out
