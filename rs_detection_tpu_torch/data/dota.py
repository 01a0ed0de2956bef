"""DOTA-style labelled datasets (counterpart of
``rs_detection_tpu/data/dota.py``): ``DOTADataset`` with the class list
of its version, the per-class repeat balancing (``BALANCE_DICT``), the
per-class submission files (``parse_result``) and the in-memory VOC-style
oriented mAP (``evaluate``, through ``devkits/voc_eval.py``), and its
subclasses ``FAIRDataset``, ``FAIR1M_1_5_Dataset`` and ``SSDDDataset``."""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from ..config.constant import get_classes_by_name
from ..ops.box_ops import rotated_box_to_poly_np
from ..utils.registry import DATASETS
from .custom import CustomDataset
from .devkits.voc_eval import voc_eval_dota


def s2anet_post(result):
    """(dets [N, 6] rotated boxes and scores, 0-based labels) -> (polys,
    scores, 1-based labels)."""
    dets, labels = result
    return rotated_box_to_poly_np(dets[:, :5]), dets[:, 5], labels + 1


# per class (repeat factor, extra copies of the first images)
BALANCE_DICT = {
    "storage-tank": (1, 526),
    "baseball-diamond": (2, 202),
    "ground-track-field": (1, 575),
    "swimming-pool": (2, 104),
    "soccer-ball-field": (1, 962),
    "roundabout": (1, 711),
    "tennis-court": (1, 655),
    "basketball-court": (4, 0),
    "helicopter": (8, 0),
    "container-crane": (50, 0),
}


@DATASETS.register_module()
class DOTADataset(CustomDataset):
    def __init__(self, *args, balance_category=False, version="1",
                 **kwargs):
        if version not in ("1", "1_5", "2"):
            raise ValueError(f"DOTADataset: unknown version {version!r}")
        self.CLASSES = get_classes_by_name("DOTA" + version)
        super().__init__(*args, **kwargs)
        if balance_category:
            self.img_infos = self._balance_categories()
            self.total_len = len(self.img_infos)

    def _balance_categories(self):
        """Every tile once per class it holds, times that class's repeat
        factor, plus its extra copies of the class's first tiles."""
        cate = {}
        for idx, info in enumerate(self.img_infos):
            for label in np.unique(info["ann"]["labels"]):
                cate.setdefault(int(label), []).append(idx)
        new_idx: List[int] = []
        for label, idxs in cate.items():
            l1, l2 = BALANCE_DICT.get(self.CLASSES[label - 1], (1, 0))
            new_idx.extend(idxs * l1 + idxs[:l2])
        return [self.img_infos[i] for i in new_idx]

    def parse_result(self, results, save_path):
        """Per-class DOTA submission files: ``results`` is a list of
        ((dets [N, 6], 0-based labels), image name) pairs."""
        os.makedirs(save_path, exist_ok=True)
        data = {}
        for (dets, labels), img_name in results:
            img_name = os.path.splitext(img_name)[0]
            for det, label in zip(dets, labels):
                poly = rotated_box_to_poly_np(det[None, :5])[0]
                line = ("{} {:.4f} " + " ".join(["{:.4f}"] * 8) + "\n") \
                    .format(img_name, det[5], *poly)
                data.setdefault(self.CLASSES[int(label)], []).append(line)
        for classname, lines in data.items():
            with open(os.path.join(save_path, classname + ".txt"),
                      "w") as f:
                f.writelines(lines)

    def evaluate(self, results, work_dir, epoch, logger=None, save=True):
        """``results``: list of ((polys, scores, 1-based labels), target)
        pairs; the targets' polygons over ``scale_factor`` are the ground
        truths, their ``polys_ignore`` the difficult ones. Saves the
        results under ``work_dir/detections/val_{epoch}`` and returns
        {"eval/<i>_<class>_AP": ap, ..., "eval/0_meanAP": mean}."""
        if save and work_dir:
            sp = os.path.join(work_dir, f"detections/val_{epoch}")
            os.makedirs(sp, exist_ok=True)
            with open(os.path.join(sp, "val.pkl"), "wb") as f:
                pickle.dump(results, f)
        dets, gts, difficult = [], [], {}
        for img_idx, (result, target) in enumerate(results):
            det_polys, det_scores, det_labels = result
            if det_polys.size > 0:
                col = np.full((len(det_labels), 1), img_idx, np.float64)
                dets.append(np.concatenate(
                    [col, det_polys.reshape(-1, 8),
                     np.asarray(det_scores).reshape(-1, 1),
                     np.asarray(det_labels).reshape(-1, 1)], axis=1))
            sf = target.get("scale_factor", 1.0)
            gt_polys = np.asarray(target["polys"], np.float64) / sf
            if gt_polys.size > 0:
                col = np.full((gt_polys.shape[0], 1), img_idx, np.float64)
                gts.append(np.concatenate(
                    [col, gt_polys.reshape(-1, 8),
                     np.asarray(target["labels"]).reshape(-1, 1)], axis=1))
            difficult[img_idx] = (np.asarray(
                target.get("polys_ignore", np.zeros((0, 8)))) / sf)

        aps = {}
        if not dets:
            for i, c in enumerate(self.CLASSES):
                aps[f"eval/{i+1}_{c}_AP"] = 0.0
            aps["eval/0_meanAP"] = 0.0
            return aps
        dets = np.concatenate(dets)
        gts = np.concatenate(gts) if gts else np.zeros((0, 10))
        for i, classname in enumerate(self.CLASSES):
            c_dets = dets[dets[:, -1] == (i + 1)][:, :-1]
            c_gts = gts[gts[:, -1] == (i + 1)][:, :-1]
            class_gts = {}
            for idx in np.unique(gts[:, 0]) if gts.size else []:
                g = c_gts[c_gts[:, 0] == idx][:, 1:]
                dg = difficult.get(idx, np.zeros((0, 8))).reshape(-1, 8)
                diff = np.zeros(g.shape[0] + dg.shape[0], bool)
                diff[g.shape[0]:] = True
                g = np.concatenate([g, dg])
                class_gts[int(idx)] = {"box": g.copy(),
                                       "det": [False] * len(g),
                                       "difficult": diff}
            _, _, ap = voc_eval_dota(c_dets, class_gts)
            aps[f"eval/{i+1}_{classname}_AP"] = float(ap)
        aps["eval/0_meanAP"] = float(np.mean(list(aps.values())))
        return aps


@DATASETS.register_module()
class FAIRDataset(DOTADataset):
    """FAIR1M with its fine classes."""

    def __init__(self, *args, **kwargs):
        kwargs.pop("version", None)
        CustomDataset.__init__(self, *args, **kwargs)
        self.CLASSES = get_classes_by_name("FAIR")


@DATASETS.register_module()
class FAIR1M_1_5_Dataset(DOTADataset):
    """FAIR1M-1.5, 10 classes."""

    def __init__(self, *args, balance_category=False, **kwargs):
        kwargs.pop("version", None)
        CustomDataset.__init__(self, *args, **kwargs)
        self.CLASSES = get_classes_by_name("FAIR1M_1_5")
        if balance_category:
            self.img_infos = self._balance_categories()
            self.total_len = len(self.img_infos)


@DATASETS.register_module()
class SSDDDataset(DOTADataset):
    """SSDD, SAR ships (one class)."""

    def __init__(self, *args, **kwargs):
        kwargs.pop("version", None)
        CustomDataset.__init__(self, *args, **kwargs)
        self.CLASSES = get_classes_by_name("SSDD")
