"""Closed-loop quality metrics of the DSN (port of
graspbalance_tpu/eval/seg_quality.py, numpy only, with its rounding).

Scores a DSN's foreground classification and mean-shift instance clustering
against the synthetic generator's true instance labels; used by
cli/dsn_quality_gate.py.
"""

from __future__ import annotations

import numpy as np


def seg_quality(fg_logits, cluster_labels, instance_label) -> dict:
    """fg_logits (B, N, 2); cluster_labels (B, N) int (0 = background, from
    models/dsn.cluster); instance_label (B, N) int (0 = table). Returns:

    fg_iou        foreground IoU (predicted vs true)
    purity        fraction of correctly-foreground points whose predicted
                  cluster's majority true instance matches their own —
                  measures whether the clustering separates OBJECTS, not
                  just foreground
    cluster_count_err  mean |#predicted clusters - #true objects| per scene
    """
    fg_pred = np.asarray(fg_logits).argmax(-1) == 1
    fg_true = np.asarray(instance_label) > 0
    labels = np.asarray(cluster_labels)
    inter = (fg_pred & fg_true).sum()
    union = (fg_pred | fg_true).sum()
    iou = float(inter) / max(float(union), 1.0)

    b = labels.shape[0]
    pure = 0.0
    total = 0.0
    count_err = 0.0
    for i in range(b):
        on = fg_pred[i] & fg_true[i] & (labels[i] > 0)
        n_true = len(np.unique(instance_label[i][fg_true[i]]))
        n_pred = len(np.unique(labels[i][labels[i] > 0]))
        count_err += abs(n_pred - n_true)
        if not on.any():
            continue
        li = labels[i][on]
        ti = np.asarray(instance_label)[i][on]
        # majority true instance per predicted cluster
        for c in np.unique(li):
            sel = li == c
            vals, cnts = np.unique(ti[sel], return_counts=True)
            pure += float(cnts.max())
            total += float(sel.sum())
    return {
        "fg_iou": round(iou, 4),
        "purity": round(pure / max(total, 1.0), 4),
        "cluster_count_err": round(count_err / max(b, 1), 2),
    }
