"""Rank-0 final test evaluation: loss, accuracy and precision/recall/F1 in
macro, weighted and micro averages (port of the JAX package's
``eval.py:21-116``, the reference's ``evaluator.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from .train import masked_token_stats
from .utils.batching import pad_to_batches


def _prf(labels: np.ndarray, preds: np.ndarray, num_classes: int,
         average: str):
    """precision/recall/F1 without a sklearn dependency (sklearn semantics:
    undefined -> 0)."""
    tp = np.zeros(num_classes)
    fp = np.zeros(num_classes)
    fn = np.zeros(num_classes)
    for c in range(num_classes):
        tp[c] = np.sum((preds == c) & (labels == c))
        fp[c] = np.sum((preds == c) & (labels != c))
        fn[c] = np.sum((preds != c) & (labels == c))
    with np.errstate(divide="ignore", invalid="ignore"):
        prec = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
        rec = np.where(tp + fn > 0, tp / (tp + fn), 0.0)
        f1 = np.where(prec + rec > 0, 2 * prec * rec / (prec + rec), 0.0)
    if average == "macro":
        return prec.mean(), rec.mean(), f1.mean()
    if average == "weighted":
        support = np.bincount(labels, minlength=num_classes).astype(np.float64)
        w = support / support.sum()
        return (prec * w).sum(), (rec * w).sum(), (f1 * w).sum()
    if average == "micro":
        p = tp.sum() / max(tp.sum() + fp.sum(), 1)
        r = tp.sum() / max(tp.sum() + fn.sum(), 1)
        f = 2 * p * r / max(p + r, 1e-12) if (p + r) > 0 else 0.0
        return p, r, f
    raise ValueError(f"unknown average {average!r}")


@torch.no_grad()
def evaluate(model: torch.nn.Module, variables: dict, images: np.ndarray,
             labels: np.ndarray, batch_size: int, *, rank: int = 0,
             verbose: bool = True):
    """Full test-set evaluation of ``model`` with parameters ``variables``
    (``state_dict`` names -> tensors, on the device to run on).

    Returns (loss, accuracy, all_preds, all_labels, metrics_dict).  The tail
    batch pads and is masked out."""
    device = next(iter(variables.values())).device
    n = len(labels)
    x, y, m = pad_to_batches(images, labels, batch_size)
    preds = []
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    for xb, yb, mb in zip(x, y, m):
        xb = torch.from_numpy(xb).to(device, torch.long)
        yb = torch.from_numpy(yb).to(device, torch.long)
        mb = torch.from_numpy(mb).to(device)
        out = functional_call(model, variables, (xb,))
        ce, w, c = masked_token_stats(out, yb, mb)
        sums += torch.stack([(ce * w).sum(), c, w.sum()]).double()
        preds.append(out.argmax(-1))
    loss_sum, correct, weight = sums.tolist()
    preds = torch.cat(preds).cpu().numpy().reshape(-1, *labels.shape[1:])[:n]
    weight = max(weight, 1.0)
    loss = loss_sum / weight
    accuracy = 100.0 * correct / weight

    if labels.ndim > 1:  # token task: score the non-ignored positions
        valid = labels >= 0
        labels_flat, preds_flat = labels[valid], preds[valid]
    else:
        labels_flat, preds_flat = labels, preds
    ncls = int(max(labels_flat.max(), preds_flat.max())) + 1
    pm, rm, fm = _prf(labels_flat, preds_flat, ncls, "macro")
    pw, rw, fw = _prf(labels_flat, preds_flat, ncls, "weighted")
    pi, ri, fi = _prf(labels_flat, preds_flat, ncls, "micro")
    metrics = dict(precision_macro=pm, recall_macro=rm, f1_macro=fm,
                   precision_weighted=pw, recall_weighted=rw, f1_weighted=fw,
                   precision_micro=pi, recall_micro=ri, f1_micro=fi)
    if verbose:
        print(f"Worker {rank}, Test Loss: {loss:.4f}, Test Accuracy: "
              f"{accuracy:.2f}%, Weighted Precision: {pw:.2f}, Weighted "
              f"Recall: {rw:.2f}, Weighted F1 Score: {fw:.2f}")
        print(f"Precision: {pm:.2f}, Recall: {rm:.2f}, F1 Score: {fm:.2f}")
        print(f"Micro Precision: {pi:.2f}, Micro Recall: {ri:.2f}, "
              f"Micro F1 Score: {fi:.2f}")
    return loss, accuracy, preds, labels, metrics
