"""Counterpart of ``youku_mplug_tpu/evals/grounding.py``, a copy of the
JAX package's module (numpy and cv2); ``grounding_eval_masks`` takes
the port's ``data.refer.Refer``.

Box utilities + grounding evaluation (reference utils/box_utils.py,
utils/eval_utils.py, refTools/refEvaluation.py): cxcywh/xyxy conversion,
IoU / generalized IoU, and the P@IoU>=0.5 referring-expression protocol."""

from __future__ import annotations

import numpy as np


def cxcywh_to_xyxy(box):
    box = np.asarray(box, np.float32)
    cx, cy, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy_to_cxcywh(box):
    box = np.asarray(box, np.float32)
    x0, y0, x1, y1 = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return np.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], -1)


def box_iou(a, b):
    """Pairwise IoU of xyxy boxes a [N,4] vs b [M,4] -> [N,M]."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    area_a = (a[:, 2] - a[:, 0]).clip(0) * (a[:, 3] - a[:, 1]).clip(0)
    area_b = (b[:, 2] - b[:, 0]).clip(0) * (b[:, 3] - b[:, 1]).clip(0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clip(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def generalized_box_iou(a, b):
    """GIoU (pairwise) — the grounding regression loss term."""
    iou = box_iou(a, b)
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    lt = np.minimum(a[:, None, :2], b[None, :, :2])
    rb = np.maximum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clip(0)
    hull = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    inter = iou * (area_a[:, None] + area_b[None, :]) / (1 + iou)
    union = area_a[:, None] + area_b[None, :] - inter
    return iou - (hull - union) / np.maximum(hull, 1e-9)


def grounding_accuracy(pred_cxcywh, gt_cxcywh, threshold: float = 0.5):
    """P@IoU>=threshold over matched (pred, gt) pairs, in percent."""
    pred = cxcywh_to_xyxy(pred_cxcywh)
    gt = cxcywh_to_xyxy(gt_cxcywh)
    ious = np.diag(box_iou(pred, gt))
    return 100.0 * float((ious >= threshold).mean()), ious


def _iou_xywh(a, b):
    """IoU of two [x, y, w, h] boxes (the refer annotation format)."""
    ax0, ay0, aw, ah = a
    bx0, by0, bw, bh = b
    x0, y0 = max(ax0, bx0), max(ay0, by0)
    x1, y1 = min(ax0 + aw, bx0 + bw), min(ay0 + ah, by0 + bh)
    inter = max(0.0, x1 - x0) * max(0.0, y1 - y0)
    union = aw * ah + bw * bh - inter
    return inter / max(union, 1e-9)


def rank_detections(mask, dets, alpha: float):
    """Pick the detection box maximizing sum(mask over box)/area**alpha.

    ``mask`` is a full-resolution [H, W] relevance map; ``dets`` is a list
    of [x, y, w, h, ...] candidate boxes (reference dataset/utils.py:
    178-189).  Returns the winning [x, y, w, h].
    """
    best, best_score = None, 0.0
    for det in dets:
        x, y, w, h = (int(det[0]), int(det[1]), int(det[2]), int(det[3]))
        score = float(mask[y:y + h, x:x + w].sum()) / max(
            float(det[2] * det[3]), 1e-9) ** alpha
        if score > best_score:
            best, best_score = det[:4], score
    return best


def grounding_eval_masks(results, dets, refer, alpha: float,
                         mask_size: int = 24):
    """Weakly-supervised RefCOCO eval (reference dataset/utils.py:162-207):
    each result is {'ref_id', 'pred': [mask_size, mask_size] relevance};
    the mask is upsampled bicubically to the image, scores every proposal
    box for that image, and the top-ranked box is checked at IoU>=0.5
    against the referred annotation.  Returns per-split accuracies
    {'val_d', 'testA_d', 'testB_d'} (splits with no refs are omitted).

    ``refer`` is a ``youku_mplug_tpu_torch.data.refer.Refer``; ``dets``
    maps str(image_id) -> list
    of [x, y, w, h, ...] proposal boxes.
    """
    import cv2

    correct = {"val": 0, "testA": 0, "testB": 0}
    total = {"val": 0, "testA": 0, "testB": 0}
    for res in results:
        ref = refer.refs[res["ref_id"]]
        ref_box = refer.ref_to_ann[res["ref_id"]]["bbox"]
        image = refer.imgs[ref["image_id"]]
        mask = np.asarray(res["pred"], np.float32).reshape(
            mask_size, mask_size)
        mask = cv2.resize(mask, (image["width"], image["height"]),
                          interpolation=cv2.INTER_CUBIC)
        pred_box = rank_detections(mask, dets[str(ref["image_id"])], alpha)
        split = ref["split"]
        if split in total:
            total[split] += 1
            if pred_box is not None and _iou_xywh(
                    ref_box, pred_box) >= 0.5:
                correct[split] += 1
    return {f"{k}_d": correct[k] / total[k] for k in total if total[k]}
