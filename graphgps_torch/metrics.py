"""Task metrics (the port's copy of the regression, binary and multiclass
classification branches of ``graphgps_tpu/metrics.py``: ``mae`` :24 …
``auroc`` :120, ``compute_task_metrics`` :219-237 and :261-277). NaN targets
mark missing labels and are left out."""
from __future__ import annotations

from typing import Dict

import numpy as np


def mae(pred: np.ndarray, true: np.ndarray) -> float:
    m = ~np.isnan(true)
    return float(np.abs(pred[m] - true[m]).mean()) if m.any() else 0.0


def mse(pred: np.ndarray, true: np.ndarray) -> float:
    m = ~np.isnan(true)
    return float(((pred[m] - true[m]) ** 2).mean()) if m.any() else 0.0


def rmse(pred: np.ndarray, true: np.ndarray) -> float:
    return float(np.sqrt(mse(pred, true)))


def r2(pred: np.ndarray, true: np.ndarray) -> float:
    """Coefficient of determination, uniform average over outputs."""
    pred = np.atleast_2d(pred.reshape(pred.shape[0], -1))
    true = np.atleast_2d(true.reshape(true.shape[0], -1))
    scores = []
    for c in range(true.shape[1]):
        t, p = true[:, c], pred[:, c]
        m = ~np.isnan(t)
        t, p = t[m], p[m]
        if t.size < 2:
            continue
        ss_res = ((t - p) ** 2).sum()
        ss_tot = ((t - t.mean()) ** 2).sum()
        scores.append(1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0)
    return float(np.mean(scores)) if scores else 0.0


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks (ties averaged)."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(x) + 1)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = ranks[order[i:j + 1]].mean()
        i = j + 1
    return ranks


def pearsonr(pred: np.ndarray, true: np.ndarray) -> float:
    m = ~np.isnan(true.ravel())
    p, t = pred.ravel()[m], true.ravel()[m]
    if p.size < 2:
        return 0.0
    p = p - p.mean()
    t = t - t.mean()
    denom = np.sqrt((p ** 2).sum() * (t ** 2).sum())
    return float((p * t).sum() / denom) if denom > 0 else 0.0


def spearmanr(pred: np.ndarray, true: np.ndarray) -> float:
    m = ~np.isnan(true.ravel())
    p, t = pred.ravel()[m], true.ravel()[m]
    if p.size < 2:
        return 0.0
    return pearsonr(_rankdata(p), _rankdata(t))


def accuracy(pred_label: np.ndarray, true: np.ndarray) -> float:
    return float((pred_label == true).mean()) if true.size else 0.0


def accuracy_sbm(pred_label: np.ndarray, true: np.ndarray) -> float:
    """Accuracy averaged over the classes present."""
    accs = [float((pred_label[true == c] == c).mean())
            for c in np.unique(true)]
    return float(np.mean(accs)) if accs else 0.0


def precision_recall_f1(pred_label: np.ndarray,
                        true: np.ndarray) -> Dict[str, float]:
    tp = float(((pred_label == 1) & (true == 1)).sum())
    fp = float(((pred_label == 1) & (true == 0)).sum())
    fn = float(((pred_label == 0) & (true == 1)).sum())
    prec = tp / (tp + fp) if tp + fp > 0 else 0.0
    rec = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    return dict(precision=prec, recall=rec, f1=f1)


def auroc(score: np.ndarray, true: np.ndarray) -> float:
    """Binary ROC-AUC by the rank statistic (ties take average ranks); 0
    when one class is absent."""
    m = ~np.isnan(true)
    score, true = score[m], true[m]
    pos = true == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.0
    ranks = _rankdata(score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def compute_task_metrics(task_type: str, pred: np.ndarray, true: np.ndarray,
                         thresh: float = 0.5) -> Dict[str, float]:
    if task_type == "regression":
        return dict(mae=mae(pred, true), mse=mse(pred, true),
                    rmse=rmse(pred, true), r2=r2(pred, true),
                    spearmanr=spearmanr(pred, true))
    if task_type == "classification_binary":
        score, t = pred.ravel(), true.ravel()
        if score.min() < 0 or score.max() > 1:   # logits → probabilities
            score = 1.0 / (1.0 + np.exp(-score))
        label = (score > thresh).astype(np.int64)
        out = {"accuracy": accuracy(label, t),
               "accuracy-SBM": accuracy_sbm(label, t)}
        out.update(precision_recall_f1(label, t))
        out["auc"] = auroc(score, t)
        return out
    if task_type == "classification":
        many = pred.ndim > 1 and pred.shape[-1] > 1
        label = (pred.argmax(axis=-1) if many
                 else pred.astype(np.int64)).ravel()
        t = true.astype(np.int64).ravel()
        out = {"accuracy": accuracy(label, t),
               "accuracy-SBM": accuracy_sbm(label, t)}
        if many:
            # macro F1 over the classes present, as VOC and COCO report it
            f1s = [precision_recall_f1((label == c).astype(int),
                                       (t == c).astype(int))["f1"]
                   for c in np.unique(t)]
            out["f1"] = float(np.mean(f1s)) if f1s else 0.0
        return out
    raise NotImplementedError(
        f"metrics for task_type={task_type!r} are not ported (multilabel "
        "ap/auc: ROADMAP Queue 1 item 17)")
