"""Batch collation (counterpart of ``rs_detection_tpu/data/collate.py``):
images stacked NHWC, zero-padded to the batch's largest, and ground-truth
arrays padded to ``max_gt`` with a validity mask, so a batch is a few
dense arrays."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

TARGET_KEYS = ("rboxes", "hboxes", "polys", "labels")


def pad_gt(arr: np.ndarray, max_gt: int, dim: int) -> np.ndarray:
    out = np.zeros((max_gt, dim), np.float32)
    n = min(arr.shape[0], max_gt) if arr is not None else 0
    if n:
        out[:n] = arr[:n, :dim]
    return out


def collate_batch(samples: List[Tuple[np.ndarray, Dict]],
                  max_gt: int = 512) -> Tuple[np.ndarray, Dict]:
    """Args:
      samples: list of (image HWC float32, target dict) from the
        transform pipeline.

    Returns:
      (images [B, H, W, 3], targets dict of dense arrays).
    """
    b = len(samples)
    hmax = max(s[0].shape[0] for s in samples)
    wmax = max(s[0].shape[1] for s in samples)
    images = np.zeros((b, hmax, wmax, 3), np.float32)
    rboxes = np.zeros((b, max_gt, 5), np.float32)
    hboxes = np.zeros((b, max_gt, 4), np.float32)
    polys = np.zeros((b, max_gt, 8), np.float32)
    labels = np.zeros((b, max_gt), np.int32)
    gt_mask = np.zeros((b, max_gt), bool)
    img_hw = np.zeros((b, 2), np.float32)
    scale = np.ones((b,), np.float32)

    for i, (img, tgt) in enumerate(samples):
        h, w = img.shape[:2]
        images[i, :h, :w] = img
        img_hw[i] = (h, w)
        if tgt is None:
            continue
        scale[i] = float(tgt.get("scale_factor", 1.0))
        n = 0
        if tgt.get("rboxes") is not None:
            n = min(len(tgt["rboxes"]), max_gt)
            rboxes[i] = pad_gt(tgt["rboxes"], max_gt, 5)
        if tgt.get("hboxes") is not None:
            n = max(n, min(len(tgt["hboxes"]), max_gt))
            hboxes[i] = pad_gt(tgt["hboxes"], max_gt, 4)
        if tgt.get("polys") is not None:
            polys[i] = pad_gt(tgt["polys"], max_gt, 8)
        if tgt.get("labels") is not None:
            m = min(len(tgt["labels"]), max_gt)
            labels[i, :m] = np.asarray(tgt["labels"])[:m]
        gt_mask[i, :n] = True

    targets = dict(rboxes=rboxes, hboxes=hboxes, polys=polys,
                   labels=labels, gt_mask=gt_mask, img_hw=img_hw,
                   scale_factor=scale)
    return images, targets
