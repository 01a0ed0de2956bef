"""Multi-model ensemble merging (counterpart of ``tools/merge_results.py``),
on the host in numpy as in the JAX tool:

* ``merge_csv_with_class``: N FAIR1M-1.5 submission CSVs, per image and
  class an hbb NMS across models (threshold 0.625, soft-NMS available),
  the merged CSV (the root ``merge.py`` of the FAIR1M-2.0 entry);
* ``merge_det_txt_dirs``: several models' per-class DOTA det-txt
  directories merged with the polygon NMS.

    python -m rs_detection_tpu_torch.tools.merge_results \\
        [--csvs A.csv B.csv ...] [--thresh 0.625] [--out merged.csv]
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Dict, List, Union

import numpy as np

from ..config.constant import FAIR1M_1_5_CLASSES
from ..ops.box_ops import HALF_PI, PI
from ..ops.nms_poly import poly_nms_numpy


def poly2obb(polys: np.ndarray) -> np.ndarray:
    """Quads [N, 8] -> obb [N, 5] in the input's precision: the JAX
    package's ``poly2obb`` (``poly_to_rotated_box`` in le90, then w >= h
    with theta wrapped into [-pi/2, pi/2))."""
    x1, y1, x2, y2, x3, y3, x4, y4 = (polys[..., i] for i in range(8))
    edge1 = np.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    edge2 = np.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    w, h = np.maximum(edge1, edge2), np.minimum(edge1, edge2)
    angle = np.where(edge1 > edge2, np.arctan2(y2 - y1, x2 - x1),
                     np.arctan2(y4 - y1, x4 - x1))
    angle = (angle + HALF_PI) % PI - HALF_PI
    swap = w > h
    theta = np.where(swap, angle, angle + HALF_PI)
    theta = (theta + HALF_PI) % PI - HALF_PI
    return np.stack([(x1 + x3) / 2.0, (y1 + y3) / 2.0, np.where(swap, w, h),
                     np.where(swap, h, w), theta], axis=-1)


def obb2hbb(obboxes: np.ndarray) -> np.ndarray:
    cx, cy, w, h, theta = (obboxes[..., i] for i in range(5))
    c, s = np.cos(theta), np.sin(theta)
    xb = np.abs(w / 2 * c) + np.abs(h / 2 * s)
    yb = np.abs(w / 2 * s) + np.abs(h / 2 * c)
    return np.stack([cx - xb, cy - yb, cx + xb, cy + yb], axis=-1)


def hbb_nms_numpy(boxes: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy hbb NMS over [N, 5] (x1 y1 x2 y2 score) -> kept indices."""
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.int64)
    x1, y1, x2, y2, s = boxes.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = np.argsort(-s)
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        xx1 = np.maximum(x1[i], x1[rest])
        yy1 = np.maximum(y1[i], y1[rest])
        xx2 = np.minimum(x2[i], x2[rest])
        yy2 = np.minimum(y2[i], y2[rest])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        iou = w * h / (areas[i] + areas[rest] - w * h)
        order = rest[iou <= thresh]
    return np.asarray(keep, np.int64)


def soft_nms_numpy(boxes: np.ndarray, thresh: float = 0.3,
                   nt: float = 0.6, sigma: float = 0.5) -> np.ndarray:
    """Gaussian soft-NMS (the ``merge.py`` soft_nms option)."""
    boxes = boxes.copy()
    idxs = np.arange(boxes.shape[0])
    keep = []
    while boxes.shape[0] > 0:
        m = int(np.argmax(boxes[:, 4]))
        keep.append(idxs[m])
        best = boxes[m].copy()
        boxes = np.delete(boxes, m, 0)
        idxs = np.delete(idxs, m, 0)
        if boxes.shape[0] == 0:
            break
        xx1 = np.maximum(best[0], boxes[:, 0])
        yy1 = np.maximum(best[1], boxes[:, 1])
        xx2 = np.minimum(best[2], boxes[:, 2])
        yy2 = np.minimum(best[3], boxes[:, 3])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        a_best = (best[2] - best[0] + 1) * (best[3] - best[1] + 1)
        a = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
        iou = w * h / (a_best + a - w * h)
        boxes[:, 4] *= np.exp(-(iou ** 2) / sigma)
        alive = boxes[:, 4] > thresh
        boxes = boxes[alive]
        idxs = idxs[alive]
    return np.asarray(keep, np.int64)


def read_csv_to_numpy(path: str) -> np.ndarray:
    """FAIR1M-1.5 CSV rows: image,cls,score,8 coords ->
    [N, 11] (img_id, 8 poly, score, class_idx1)."""
    rows = []
    cls_idx = {c: i + 1 for i, c in enumerate(FAIR1M_1_5_CLASSES)}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 11:
                continue
            img_id = float(os.path.splitext(parts[0])[0])
            rows.append([img_id] + [float(v) for v in parts[3:11]]
                        + [float(parts[2]), float(cls_idx[parts[1]])])
    return np.asarray(rows, np.float64)


def merge_csv_with_class(data_list: List[np.ndarray],
                         thresh: Union[float, Dict[str, float]] = 0.625,
                         use_soft: bool = False) -> np.ndarray:
    """Per-image-per-class cross-model hbb NMS."""
    data = np.concatenate(data_list)
    result = []
    for image_id in np.unique(data_list[0][:, 0]):
        image_dets = data[data[:, 0] == image_id]
        for ci, class_name in enumerate(FAIR1M_1_5_CLASSES):
            t = (thresh[class_name] if isinstance(thresh, dict)
                 else thresh)
            cd = image_dets[image_dets[:, -1] == ci + 1]
            if cd.shape[0] == 0:
                continue
            hbb = obb2hbb(poly2obb(cd[:, 1:9]))
            proposal = np.concatenate([hbb, cd[:, 9:10]], 1)
            keep = (soft_nms_numpy(proposal) if use_soft
                    else hbb_nms_numpy(proposal, t))
            if keep.size:
                result.append(cd[keep])
    return np.concatenate(result) if result else np.zeros((0, 11))


def save_to_csv(result: np.ndarray, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for row in result:
            img = str(int(row[0])) + ".tif"
            cls = FAIR1M_1_5_CLASSES[int(row[-1]) - 1]
            f.write(f"{img},{cls},{row[9]:.4f},"
                    + ",".join(f"{v:.4f}" for v in row[1:9]) + "\n")


def merge_det_txt_dirs(src_dirs: List[str], dst_dir: str,
                       nms_thresh: float = 0.1):
    """Merge several models' per-class DOTA det-txt dirs with poly NMS."""
    os.makedirs(dst_dir, exist_ok=True)
    classes = sorted({f for d in src_dirs for f in os.listdir(d)
                      if f.endswith(".txt")})
    for cls_file in classes:
        per_image: Dict[str, List] = {}
        for d in src_dirs:
            p = os.path.join(d, cls_file)
            if not os.path.exists(p):
                continue
            with open(p) as f:
                for line in f:
                    parts = line.strip().split(" ")
                    if len(parts) < 10:
                        continue
                    per_image.setdefault(parts[0], []).append(
                        [float(v) for v in parts[2:10]]
                        + [float(parts[1])])
        with open(os.path.join(dst_dir, cls_file), "w") as out:
            for img, dets in per_image.items():
                arr = np.asarray(dets)
                keep = poly_nms_numpy(arr, nms_thresh)
                for k in keep:
                    out.write(img + " " + str(arr[k, 8]) + " "
                              + " ".join(str(v) for v in arr[k, :8])
                              + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--csvs", nargs="*", default=None,
                    help="submission CSVs to ensemble")
    ap.add_argument("--thresh", type=float, default=0.625)
    ap.add_argument("--out", default="csv_merge/merged_result.csv")
    args = ap.parse_args(argv)
    paths = args.csvs or sorted(glob.glob("submit_zips/*.csv"))
    if len(paths) < 2:
        raise SystemExit("merge_results: need at least 2 submissions")
    data_list = [read_csv_to_numpy(p) for p in paths]
    result = merge_csv_with_class(data_list, args.thresh)
    save_to_csv(result, args.out)
    print("merged ->", args.out)


if __name__ == "__main__":
    main()
