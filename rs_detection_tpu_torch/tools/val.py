"""Offline FAIR1M-1.5 evaluation of a submission (counterpart of
``tools/val.py``): a submission CSV against a directory of ground-truth
XML files, the VOC-style oriented AP per class and their mean.

    python -m rs_detection_tpu_torch.tools.val --csv SUB.csv \\
        --gt_xml_dir DIR
"""

from __future__ import annotations

import argparse
import os
import xml.etree.ElementTree as ET

import numpy as np

from ..config.constant import FAIR1M_1_5_CLASSES
from ..data.devkits.voc_eval import voc_eval_dota


def load_gt_xml_dir(xml_dir):
    """{image id: [(class name, polygon [8], difficult)]} of the XML
    files in ``xml_dir`` (spaces in class names become underscores)."""
    gt = {}
    for f in sorted(os.listdir(xml_dir)):
        if not f.endswith(".xml"):
            continue
        objs = []
        tree = ET.parse(os.path.join(xml_dir, f))
        for obj in tree.getroot().iter("object"):
            name = (obj.findtext("possibleresult/name") or "").strip()
            name = name.replace(" ", "_")
            pts = []
            for pt in obj.iter("point"):
                x, y = (pt.text or "0,0").split(",")
                pts += [float(x), float(y)]
            if len(pts) >= 8:
                objs.append((name, np.asarray(pts[:8]), 0))
        gt[os.path.splitext(f)[0]] = objs
    return gt


def load_submission_csv(path):
    """{class name: [(image id, score, polygon [8])]} of the rows
    ``image,class,score,x1,y1,...,x4,y4``."""
    dets = {}
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 11:
                continue
            img_id = os.path.splitext(parts[0])[0]
            poly = np.asarray([float(v) for v in parts[3:11]])
            dets.setdefault(parts[1], []).append(
                (img_id, float(parts[2]), poly))
    return dets


def evaluate(csv_path, xml_dir, classes=None):
    """{class: AP, ..., "meanAP": mean over ``classes``} (the FAIR1M-1.5
    classes by default); a class without detections or ground truths
    has AP 0."""
    classes = classes or FAIR1M_1_5_CLASSES
    gt = load_gt_xml_dir(xml_dir)
    dets = load_submission_csv(csv_path)
    id_map = {img: i for i, img in enumerate(sorted(gt))}
    aps = {}
    for cls in classes:
        class_gts = {}
        for img, objs in gt.items():
            boxes = [p for (n, p, d) in objs if n == cls]
            diffs = [bool(d) for (n, p, d) in objs if n == cls]
            if boxes:
                class_gts[id_map[img]] = {"box": np.stack(boxes),
                                          "det": [False] * len(boxes),
                                          "difficult": np.asarray(diffs)}
        rows = [[id_map[img], *poly, score]
                for (img, score, poly) in dets.get(cls, []) if img in id_map]
        if not rows or not class_gts:
            aps[cls] = 0.0
            continue
        _, _, ap = voc_eval_dota(np.asarray(rows), class_gts)
        aps[cls] = float(ap)
    aps["meanAP"] = float(np.mean([aps[c] for c in classes]))
    return aps


def main(argv=None):
    ap = argparse.ArgumentParser(description="FAIR1M-1.5 offline AP")
    ap.add_argument("--csv", required=True)
    ap.add_argument("--gt_xml_dir", required=True)
    args = ap.parse_args(argv)
    aps = evaluate(args.csv, args.gt_xml_dir)
    for k, v in aps.items():
        print(f"{k:24s} {v:.4f}")
    return aps


if __name__ == "__main__":
    main()
