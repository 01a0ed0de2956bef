"""Submission assembly (counterpart of
``rs_detection_tpu/data/devkits/data_merge.py``): the results pickle ->
per-class txt files with the flip-TTA boxes flipped back -> tile merge
-> the DOTA zip, FAIR XML files or FAIR1M-1.5 CSV. ``submit_zips/`` is
relative to the working directory, as in the JAX package."""

from __future__ import annotations

import os
import pickle
import shutil
import zipfile
from typing import Dict, List

from ...config.constant import get_classes_by_name
from .result_merge import mergebypoly


def flip_box(box, target):
    """Undo test-time flips in the original image's frame."""
    ans = [float(box[i]) for i in range(8)]
    mode = target.get("flip_mode")
    if not mode:
        return ans
    w, h = target["ori_img_size"]
    if "H" in mode:
        for i in (0, 2, 4, 6):
            ans[i] = w - ans[i]
    if "V" in mode:
        for i in (1, 3, 5, 7):
            ans[i] = h - ans[i]
    return ans


def prepare_data(result_pkl: str, save_path: str, classes: List[str]):
    os.makedirs(save_path, exist_ok=True)
    with open(result_pkl, "rb") as f:
        results = pickle.load(f)
    data: Dict[str, List[str]] = {}
    for result, target in results:
        img_name = os.path.splitext(
            os.path.basename(target["img_file"]))[0]
        polys, scores, labels = result
        for bbox, score, label in zip(polys, scores, labels):
            classname = classes[int(label) - 1]
            b = flip_box(bbox, target)
            line = ("{} {:.4f} " + " ".join(["{:.4f}"] * 8) + "\n") \
                .format(img_name, float(score), *b)
            data.setdefault(classname, []).append(line)
    for classname, lines in data.items():
        with open(os.path.join(save_path, classname + ".txt"), "w") as f:
            f.writelines(lines)


def data_merge(result_pkl, save_path, final_path, dataset_type,
               nms_threshold_type=0):
    classes = get_classes_by_name(dataset_type)
    prepare_data(result_pkl, save_path, classes)
    os.makedirs(final_path, exist_ok=True)
    mergebypoly(save_path, final_path,
                nms_threshold_type=nms_threshold_type)


def data_merge_result(result_pkl, work_dir, epoch, name,
                      dataset_type="DOTA", images_dir="",
                      nms_threshold_type=0):
    """The whole submission pipeline; returns the zip's or CSV's path."""
    if dataset_type not in ("FAIR", "DOTA", "DOTA1_5", "DOTA2",
                            "FAIR1M_1_5"):
        raise ValueError(f"data_merge_result: unknown dataset_type "
                         f"{dataset_type!r}")
    save_path = os.path.join(work_dir, f"test/submit_{epoch}/before_nms")
    final_path = os.path.join(work_dir, f"test/submit_{epoch}/after_nms")
    for p in (save_path, final_path):
        if os.path.exists(p):
            shutil.rmtree(p)
    os.makedirs("submit_zips", exist_ok=True)
    data_merge(result_pkl, save_path, final_path, dataset_type,
               nms_threshold_type)

    if dataset_type == "FAIR":
        from .dota_to_fair import dota_to_fair
        fair_path = os.path.join(work_dir,
                                 f"test/submit_{epoch}/final_fair/test")
        dota_to_fair(final_path, fair_path, images_dir)
        final_path = fair_path
        zip_path = os.path.join("submit_zips", name + ".zip")
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
            for f in sorted(os.listdir(final_path)):
                z.write(os.path.join(final_path, f),
                        os.path.join("test", f))
        return zip_path
    if dataset_type == "FAIR1M_1_5":
        from .dota_to_fair import dota_to_fair1m_1_5
        fair_path = os.path.join(
            work_dir, f"test/submit_{epoch}/final_fair1m_1_5/test")
        dota_to_fair1m_1_5(final_path, fair_path, images_dir, name)
        csv_src = os.path.join(fair_path, name + ".csv")
        csv_dst = os.path.join("submit_zips", name + ".csv")
        if os.path.exists(csv_src):
            shutil.move(csv_src, csv_dst)
        return csv_dst
    zip_path = os.path.join("submit_zips", name + ".zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
        for f in sorted(os.listdir(final_path)):
            z.write(os.path.join(final_path, f), f)
    return zip_path
