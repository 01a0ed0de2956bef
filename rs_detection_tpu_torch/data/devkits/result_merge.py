"""Tile merge (counterpart of
``rs_detection_tpu/data/devkits/result_merge.py``): per-tile detections
back into original-image coordinates by the tile name
``name__rate__left___up``, then a polygon NMS per original image with
the global 0.1 threshold or the FAIR1M-1.5 per-class table, one process
per class file. The NMS is the native core, ``native.poly_nms_native``
(what ``ops.nms_poly.poly_nms`` calls), imported without the ``ops``
package: a spawned worker then loads numpy and the core, not torch.
"""

from __future__ import annotations

import multiprocessing
import os
import re
from functools import partial
from typing import Dict, List

import numpy as np

from ...native import poly_nms_library, poly_nms_native

NMS_THRESHOLD_GLOBAL = 0.1
NMS_THRESHOLD_PER_CLASS = {
    'Roundabout': 0.1, 'Tennis_Court': 0.1, 'Football_Field': 0.1,
    'Vehicle': 0.15, 'Ship': 0.2, 'Airplane': 0.3, 'Intersection': 0.3,
    'Bridge': 0.0001, 'Basketball_Court': 0.1, 'Baseball_Field': 0.1,
}

_TILE_XY = re.compile(r"__\d+___\d+")
_TILE_RATE = re.compile(r"__([\d+\.]+)__\d+___")


def parse_tile_name(subname: str):
    """'img__rate__x___y' -> (origname, x, y, rate)."""
    origname = subname.split("__")[0]
    xy = _TILE_XY.findall(subname)[0]
    nums = re.findall(r"\d+", xy)
    x, y = int(nums[0]), int(nums[1])
    rate = float(_TILE_RATE.findall(subname)[0])
    return origname, x, y, rate


def poly2origpoly(poly, x, y, rate):
    out = np.asarray(poly, np.float64).copy()
    out[0::2] = (out[0::2] + x) / rate
    out[1::2] = (out[1::2] + y) / rate
    return out


def mergesingle(dstpath: str, fullname: str,
                nms_threshold_type: int = 0):
    """Merge one class file: group tiles by original image, transform
    coordinates, per-image poly NMS, write merged txt."""
    name = os.path.splitext(os.path.basename(fullname))[0]
    os.makedirs(dstpath, exist_ok=True)
    dstname = os.path.join(dstpath, name + ".txt")
    nameboxdict: Dict[str, List] = {}
    with open(fullname, "r") as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 10:
                continue
            subname = parts[0]
            origname, x, y, rate = parse_tile_name(subname)
            confidence = float(parts[1])
            poly = poly2origpoly([float(v) for v in parts[2:10]],
                                 x, y, rate)
            det = list(poly) + [confidence]
            nameboxdict.setdefault(origname, []).append(det)

    if nms_threshold_type == 0:
        thresh = NMS_THRESHOLD_GLOBAL
    else:
        thresh = NMS_THRESHOLD_PER_CLASS.get(name, NMS_THRESHOLD_GLOBAL)

    with open(dstname, "w") as f:
        for imgname, dets in nameboxdict.items():
            arr = np.asarray(dets, np.float64)
            keep = poly_nms_native(arr, thresh)
            for k in keep:
                det = arr[k]
                f.write(imgname + " " + str(det[-1]) + " "
                        + " ".join(str(v) for v in det[:8]) + "\n")


def mergebypoly(srcpath: str, dstpath: str,
                nms_threshold_type: int = 0, num_process: int = 16):
    """Merge every class file in ``srcpath``, one worker process per class
    file (spawned: the caller may hold a CUDA context), at most
    ``num_process`` at a time."""
    os.makedirs(dstpath, exist_ok=True)
    files = [os.path.join(srcpath, f) for f in sorted(os.listdir(srcpath))
             if f.endswith(".txt")]
    poly_nms_library()  # build the core once, before the workers load it
    if num_process <= 1 or len(files) <= 1:
        for f in files:
            mergesingle(dstpath, f, nms_threshold_type)
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(num_process, len(files))) as pool:
            pool.map(partial(mergesingle, dstpath,
                             nms_threshold_type=nms_threshold_type),
                     files)


def mergebyobb(srcpath: str, dstpath: str, num_process: int = 16):
    """The obb merge of the reference: ``mergebypoly``'s pipeline, whose
    exact polygon NMS covers obbs (their polygons are rectangles)."""
    mergebypoly(srcpath, dstpath, num_process=num_process)
