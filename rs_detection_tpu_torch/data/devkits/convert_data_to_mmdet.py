"""labelTxt -> mmdet-style ``labels.pkl`` converter (counterpart of
``rs_detection_tpu/data/devkits/convert_data_to_mmdet.py``): polygon ->
rotated box in the configured ``angle_version``; difficult 0 = a training
ground truth, 1 = the ignore list, 2 (the tiler's badly-cut relabel) =
dropped; optional FAIR1M-2.0 -> FAIR1M-1.5 class mapping
(``FAIR1M_MAPPING``).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
from PIL import Image

from ...config.constant import FAIR1M_MAPPING, get_classes_by_name
from ...ops.box_ops import poly_to_rotated_box_np


def parse_ann_info(label_path, img_name, label_ids, angle_version,
                   mapping=None):
    lab = os.path.join(label_path, img_name + ".txt")
    bboxes, labels, bboxes_ignore, labels_ignore = [], [], [], []
    with open(lab, "r", errors="ignore") as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 10:
                continue
            try:
                poly = [float(parts[i]) for i in range(8)]
            except ValueError:
                continue
            rbox = poly_to_rotated_box_np(
                np.asarray(poly, np.float32)[None], angle_version)[0]
            name = parts[8]
            if mapping is not None:
                name = mapping[name]
            difficult = int(parts[9])
            if difficult == 0:
                bboxes.append(rbox)
                labels.append(label_ids[name])
            elif difficult == 1:
                bboxes_ignore.append(rbox)
                labels_ignore.append(label_ids[name])
            # difficult == 2: dropped entirely
    return bboxes, labels, bboxes_ignore, labels_ignore


def convert_data_to_mmdet(src_path, out_path, trainval=True,
                          filter_empty_gt=True, ext=".png", type="",
                          angle_version="le135",
                          mapping: Optional[dict] = None):
    label_ids = {n: i + 1
                 for i, n in enumerate(get_classes_by_name(type))}
    img_path = os.path.join(src_path, "images")
    label_path = os.path.join(src_path, "labelTxt")
    data = []
    for img_file in sorted(os.listdir(img_path)):
        img_name = os.path.splitext(img_file)[0]
        label = os.path.join(label_path, img_name + ".txt")
        with Image.open(os.path.join(img_path, img_file)) as im:
            info = dict(filename=img_name + ext, height=im.height,
                        width=im.width)
        if trainval:
            if not os.path.exists(label):
                continue
            if filter_empty_gt and os.path.getsize(label) == 0:
                continue
            b, l, bi, li = parse_ann_info(label_path, img_name,
                                          label_ids, angle_version,
                                          mapping)
            info["ann"] = dict(
                bboxes=np.asarray(b, np.float32).reshape(-1, 5),
                labels=np.asarray(l, np.int64),
                bboxes_ignore=np.asarray(bi, np.float32).reshape(-1, 5),
                labels_ignore=np.asarray(li, np.int64))
        data.append(info)
    with open(out_path, "wb") as f:
        pickle.dump(data, f)
    return out_path


def convert_data_to_mmdet_mapping(src_path, out_path, **kw):
    """FAIR1M2 fine classes -> FAIR1M-1.5 coarse classes."""
    kw.setdefault("mapping", FAIR1M_MAPPING)
    return convert_data_to_mmdet(src_path, out_path, **kw)
