"""Oriented boxes drawn on images with Pillow (counterpart of
``draw_bboxes``, ``visualize_results`` and ``visualize_dota`` in
``rs_detection_tpu/utils/visualization.py``)."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

# the DOTA palette (rs_detection_tpu/config/constant.py:DOTA_COLORS), RGB
DOTA_COLORS = np.array([
    [244, 67, 54], [233, 30, 99], [156, 39, 176], [103, 58, 183],
    [63, 81, 181], [33, 150, 243], [0, 188, 212], [0, 150, 136],
    [76, 175, 80], [139, 195, 74], [205, 220, 57], [255, 235, 59],
    [255, 152, 0], [255, 87, 34], [212, 85, 72],
], dtype=np.float32) / 255.0


def _color(label: int) -> Tuple[int, int, int]:
    c = DOTA_COLORS[int(label) % len(DOTA_COLORS)] * 255
    return tuple(int(v) for v in c)


def draw_bboxes(image: Image.Image, polys: np.ndarray,
                scores: Optional[np.ndarray] = None,
                labels: Optional[np.ndarray] = None,
                class_names: Optional[Sequence[str]] = None,
                score_thr: float = 0.3, width: int = 2) -> Image.Image:
    """Draw oriented quads (with optional class/score text)."""
    img = image.copy()
    d = ImageDraw.Draw(img)
    polys = np.asarray(polys).reshape(-1, 8)
    for i, poly in enumerate(polys):
        if scores is not None and scores[i] < score_thr:
            continue
        label = int(labels[i]) if labels is not None else 0
        color = _color(label)
        pts = [(poly[j], poly[j + 1]) for j in range(0, 8, 2)]
        d.polygon(pts, outline=color, width=width)
        if scores is not None:
            name = (class_names[label - 1]
                    if class_names and 0 < label <= len(class_names)
                    else str(label))
            d.text((poly[0], poly[1] - 10), f"{name} {scores[i]:.2f}",
                   fill=color)
    return img


def visualize_results(results: List, classes, img_files: List[str],
                      save_dir: str, score_thr: float = 0.3):
    """results: per image (polys, scores, labels); one drawn image per
    file, under its own name in ``save_dir``."""
    os.makedirs(save_dir, exist_ok=True)
    for (polys, scores, labels), path in zip(results, img_files):
        with Image.open(path) as img:
            out = draw_bboxes(img.convert("RGB"), polys, scores, labels,
                              classes, score_thr)
        out.save(os.path.join(save_dir, os.path.basename(path)))


def visualize_dota(det_dir: str, images_dir: str, save_dir: str,
                   score_thr: float = 0.3):
    """Read the per-class DOTA detection files (``<class>.txt``: image
    name, score, 8 coordinates a line) and draw each image's detections
    into ``save_dir/<image>.png``; classes are numbered 1.. in sorted
    order, an image found under ``images_dir`` as .png, .jpg or .tif."""
    per_image = {}
    for f in sorted(os.listdir(det_dir)):
        if not f.endswith(".txt"):
            continue
        cls = f[:-4]
        with open(os.path.join(det_dir, f)) as fh:
            for line in fh:
                parts = line.strip().split(" ")
                if len(parts) < 10:
                    continue
                img = parts[0]
                score = float(parts[1])
                poly = [float(v) for v in parts[2:10]]
                per_image.setdefault(img, []).append((cls, score, poly))
    os.makedirs(save_dir, exist_ok=True)
    classes = sorted({c for dets in per_image.values()
                      for c, _, _ in dets})
    cls_idx = {c: i + 1 for i, c in enumerate(classes)}
    for img_name, dets in per_image.items():
        for ext in (".png", ".jpg", ".tif"):
            path = os.path.join(images_dir, img_name + ext)
            if os.path.exists(path):
                break
        else:
            continue
        with Image.open(path) as img:
            out = draw_bboxes(
                img.convert("RGB"), np.asarray([d[2] for d in dets]),
                np.asarray([d[1] for d in dets]),
                np.asarray([cls_idx[d[0]] for d in dets]), classes,
                score_thr)
        out.save(os.path.join(save_dir, img_name + ".png"))
