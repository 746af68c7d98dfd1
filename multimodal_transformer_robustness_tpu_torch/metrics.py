"""Evaluation metrics: the output contract of the robustness sweep.

Counterpart of ``multimodal_transformer_robustness_tpu/metrics.py``, numpy
ports of the reference's ``src/eval_metrics.py``.  ``eval_mosei_senti``
prints the reference's keys ("MAE", "Correlation Coefficient",
"mult_acc_7", "mult_acc_5", "F1 score", "Accuracy") line for line.

The JAX package takes ``accuracy_score`` and ``f1_score`` from sklearn,
which the card's machine lacks; :func:`accuracy_score` and
:func:`weighted_f1_score` compute the same numbers in numpy, with
sklearn's formula (per class ``2 tp / (true + predicted)``, averaged with
the class's support in the first argument as its weight; a class that one
side never names scores 0, with no exception).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def multiclass_acc(preds: np.ndarray, truths: np.ndarray) -> float:
    """Round-and-compare accuracy (reference eval_metrics.py:9-10)."""
    preds = np.asarray(preds)
    truths = np.asarray(truths)
    return float(np.sum(np.round(preds) == np.round(truths)) / float(len(truths)))


def binary_acc(results: np.ndarray, truths: np.ndarray, exclude_zero: bool = True) -> float:
    """Sign-agreement accuracy, optionally excluding zero labels
    (reference eval_metrics.py:17-24)."""
    test_preds = np.asarray(results).reshape(-1)
    test_truth = np.asarray(truths).reshape(-1)
    non_zeros = np.array(
        [i for i, e in enumerate(test_truth) if e != 0 or (not exclude_zero)])
    binary_truth = test_truth[non_zeros] > 0
    binary_preds = test_preds[non_zeros] > 0
    return float(np.mean(binary_truth == binary_preds))


def mosei_multiclass_acc(test_preds: np.ndarray, test_truth: np.ndarray) -> float:
    test_preds = np.asarray(test_preds).reshape(-1)
    test_truth = np.asarray(test_truth).reshape(-1)
    return multiclass_acc(np.clip(test_preds, -3.0, 3.0), np.clip(test_truth, -3.0, 3.0))


def weighted_accuracy(test_preds_emo: np.ndarray, test_truth_emo: np.ndarray) -> float:
    """(reference eval_metrics.py:34-42)"""
    true_label = np.asarray(test_truth_emo) > 0
    predicted_label = np.asarray(test_preds_emo) > 0
    tp = float(np.sum((true_label == 1) & (predicted_label == 1)))
    tn = float(np.sum((true_label == 0) & (predicted_label == 0)))
    p = float(np.sum(true_label == 1))
    n = float(np.sum(true_label == 0))
    return (tp * (n / p) + tn) / (2 * n)


def accuracy_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn's ``accuracy_score``: the share of equal entries."""
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def weighted_f1_score(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """sklearn's ``f1_score(y_true, y_pred, average="weighted")``: over the
    sorted union of labels, ``2 tp / (true + predicted)`` per class, averaged
    with each class's count in ``y_true`` as its weight."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.unique(np.concatenate([y_true, y_pred]))
    scores, support = [], []
    for label in labels:
        t, p = y_true == label, y_pred == label
        tp, n_true, n_pred = np.sum(t & p), np.sum(t), np.sum(p)
        scores.append(2.0 * tp / (float(n_true) + float(n_pred)))
        support.append(n_true)
    return float(np.average(np.asarray(scores, np.float64), weights=np.asarray(support)))


def eval_mosei_senti(results: np.ndarray, truths: np.ndarray,
                     exclude_zero: bool = False, quiet: bool = False) -> Dict[str, float]:
    """MAE / Pearson corr / acc7 / acc5 / weighted F1 / binary accuracy,
    printed in the reference's format (eval_metrics.py:44-68) and returned
    as a dict.  The F1 keeps the JAX package's argument order: the weights
    are the support of the predictions' signs."""
    test_preds = np.asarray(results).reshape(-1)
    test_truth = np.asarray(truths).reshape(-1)
    non_zeros = np.array(
        [i for i, e in enumerate(test_truth) if e != 0 or (not exclude_zero)])

    test_preds_a7 = np.clip(test_preds, -3.0, 3.0)
    test_truth_a7 = np.clip(test_truth, -3.0, 3.0)
    test_preds_a5 = np.clip(test_preds, -2.0, 2.0)
    test_truth_a5 = np.clip(test_truth, -2.0, 2.0)

    mae = float(np.mean(np.absolute(test_preds - test_truth)))
    corr = float(np.corrcoef(test_preds, test_truth)[0][1])
    mult_a7 = multiclass_acc(test_preds_a7, test_truth_a7)
    mult_a5 = multiclass_acc(test_preds_a5, test_truth_a5)
    f_score = weighted_f1_score(test_preds[non_zeros] > 0, test_truth[non_zeros] > 0)
    acc = accuracy_score(test_truth[non_zeros] > 0, test_preds[non_zeros] > 0)

    if not quiet:
        print("\"MAE\": ", mae, ",")
        print("\"Correlation Coefficient\": ", corr, ",")
        print("\"mult_acc_7\": ", mult_a7, ",")
        print("\"mult_acc_5\": ", mult_a5, ",")
        print("\"F1 score\": ", f_score, ",")
        print("\"Accuracy\": ", acc, ",")
    return {"MAE": mae, "Correlation Coefficient": corr, "mult_acc_7": mult_a7,
            "mult_acc_5": mult_a5, "F1 score": f_score, "Accuracy": acc}
