"""Large-image tiler (counterpart of
``rs_detection_tpu/data/devkits/img_split.py``): the sliding-window
splitter of DOTA / FAIR scenes with the same window loop, the same
``half_iou`` keep rule and ``difficult=2`` relabel of badly cut objects,
the same 5- to 4-point repair, best point order and tile names
``name__rate__left___up``, and zero-padded tiles.

Where the work runs:

* the parent decodes a scene (Pillow, RGB; cv2's ``imread`` gives the
  same pixels for 8-bit PNG, TIFF and JPEG) and resizes it on
  ``device`` (the card unless the caller passes ``device="cpu"``) with
  ``device_resize.resize_cubic_rate``, cv2's ``fx = rate`` resize within
  1 LSB; one scene at a time, the resized scene comes back to the host
  once;
* a thread pool of ``num_process`` workers cuts the windows, clips the
  labels and encodes the PNGs (Pillow, ``compress_level=1``, cv2's
  default). The JAX tiler forks a process pool; a forked child cannot
  use CUDA, so the card stays in the parent and the workers are threads
  (Pillow's encoder and numpy release the interpreter lock). A worker
  that fails raises in the parent: no scene is skipped.

``splitbase.stats`` holds the parent's seconds (``decode`` with the
label file's parse, ``resize`` with its copies, ``wait`` for the pool),
the workers' summed seconds (``cut``, ``labels``, ``encode``; a worker
waiting for the interpreter lock counts too) and the counts of
``scenes`` (one a scene and rate) and ``windows``. Each scene is decoded
once for all its rates (the JAX tiler decodes it once a rate; the tiles
are the same).
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch
from PIL import Image

from ...flagship import resolve_device
from ...ops.nms_poly import clip_polygons, polygon_area
from ..device_resize import resize_cubic_rate

STAGES = ("decode", "resize", "wait", "cut", "labels", "encode")


def parse_dota_poly(label_file: str) -> List[Dict]:
    """Parse a DOTA labelTxt: rows 'x1 y1 ... x4 y4 name difficult'."""
    objects = []
    if not os.path.exists(label_file):
        return objects
    with open(label_file, "r", errors="ignore") as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 9:
                continue  # header lines (imagesource / gsd)
            try:
                poly = [float(p) for p in parts[:8]]
            except ValueError:
                continue
            name = parts[8]
            difficult = int(parts[9]) if len(parts) > 9 else 0
            objects.append(dict(poly=poly, name=name, difficult=difficult))
    return objects


def choose_best_pointorder_fit_another(poly1, poly2):
    """The cyclic rotation of poly1 closest to poly2."""
    p1 = np.asarray(poly1, np.float64)
    p2 = np.asarray(poly2, np.float64)
    best, best_d = p1, np.inf
    for k in range(4):
        cand = np.roll(p1.reshape(4, 2), -k, axis=0).reshape(8)
        d = np.sum((cand - p2) ** 2)
        if d < best_d:
            best, best_d = cand, d
    return best


def get_poly4_from_poly5(poly):
    """Merge the shortest edge's endpoints."""
    pts = np.asarray(poly, np.float64).reshape(5, 2)
    dists = [np.hypot(*(pts[i] - pts[(i + 1) % 5])) for i in range(5)]
    pos = int(np.argmin(dists))
    out = []
    count = 0
    while count < 5:
        if count == pos:
            out.append((pts[count] + pts[(count + 1) % 5]) / 2.0)
            count += 1
        elif count == (pos + 1) % 5:
            count += 1
        else:
            out.append(pts[count])
            count += 1
    return np.asarray(out).reshape(-1)


def _clean_ring(verts: np.ndarray, tol: float = 1e-8) -> np.ndarray:
    """Drop consecutive duplicates (mirrors shapely ring cleanup)."""
    if len(verts) == 0:
        return verts
    keep = [verts[0]]
    for v in verts[1:]:
        if np.hypot(*(v - keep[-1])) > tol:
            keep.append(v)
    if len(keep) > 1 and np.hypot(*(keep[0] - keep[-1])) <= tol:
        keep.pop()
    return np.asarray(keep)


def _orient_ccw(verts: np.ndarray) -> np.ndarray:
    """Force positive (counter-clockwise) shoelace orientation
    (shapely ``orient(sign=1)``)."""
    if len(verts) < 3:
        return verts
    s = 0.0
    for i in range(len(verts)):
        a, b = verts[i], verts[(i + 1) % len(verts)]
        s += a[0] * b[1] - b[0] * a[1]
    return verts if s >= 0 else verts[::-1]


class splitbase:
    def __init__(self, basepath, outpath, code="utf-8", gap=512,
                 subsize=1024, thresh=0.7, choosebestpoint=True,
                 ext=".png", padding=True, num_process=8, yx_style=False,
                 device=None):
        self.basepath = basepath
        self.outpath = outpath
        self.gap = gap
        self.subsize = subsize
        self.slide = subsize - gap
        self.thresh = thresh
        self.choosebestpoint = choosebestpoint
        self.ext = ext
        self.padding = padding
        self.num_process = num_process
        self.yx_style = yx_style
        self.device = resolve_device(device)
        self.imagepath = os.path.join(basepath, "images")
        self.labelpath = os.path.join(basepath, "labelTxt")
        self.process_label = os.path.exists(self.labelpath)
        self.outimagepath = os.path.join(outpath, "images")
        self.outlabelpath = os.path.join(outpath, "labelTxt")
        os.makedirs(self.outimagepath, exist_ok=True)
        if self.process_label:
            os.makedirs(self.outlabelpath, exist_ok=True)
        self.stats = dict.fromkeys(STAGES, 0.0)
        self.stats.update(scenes=0, windows=0)

    # ------------------------------------------------------------------

    def _clip_poly_to_tile(self, poly, left, up, right, down):
        """Returns (half_iou, clipped_poly_or_None)."""
        p = np.asarray(poly, np.float64).reshape(4, 2)
        area = polygon_area(p[None], np.array([4]))[0]
        if area <= 0:
            return 0.0, None
        tile = np.array([[left, up], [right, up], [right, down],
                         [left, down]], np.float64)
        verts, counts = clip_polygons(p[None], np.array([4]), tile)
        inter_area = polygon_area(verts, counts)[0]
        half_iou = inter_area / area
        if counts[0] < 3:
            return half_iou, None
        ring = _clean_ring(verts[0, :counts[0]])
        return half_iou, ring

    def tile_labels(self, objects, left, up, right, down) -> List[str]:
        """The labelTxt lines of one window."""
        lines = []
        for obj in objects:
            x0, y0, x1, y1 = obj["box"]
            if x1 < left or x0 > right or y1 < up or y0 > down:
                continue  # no overlap: half_iou 0, no line
            half_iou, ring = self._clip_poly_to_tile(
                obj["poly"], left, up, right, down)
            if self.yx_style and half_iou > 0.5:
                sub = self._to_sub(obj["poly"], left, up)
                lines.append(self._fmt(sub, obj["name"], 0))
                continue
            if half_iou >= 1.0 - 1e-9:
                sub = self._to_sub(obj["poly"], left, up)
                lines.append(self._fmt(sub, obj["name"],
                                       obj["difficult"]))
            elif half_iou > 0 and ring is not None:
                ring = _orient_ccw(ring)
                if len(ring) < 4:
                    continue
                flat = ring.reshape(-1)
                if len(ring) == 5:
                    flat = get_poly4_from_poly5(flat)
                elif len(ring) > 5:
                    continue  # reference drops >5-gon cuts
                if self.choosebestpoint:
                    flat = choose_best_pointorder_fit_another(
                        flat, obj["poly"])
                sub = self._to_sub(flat, left, up)
                sub = np.clip(sub, 1, self.subsize)
                diff = (obj["difficult"] if half_iou > self.thresh
                        else 2)  # badly-cut -> difficult=2
                lines.append(self._fmt(sub, obj["name"], diff))
        return lines

    @staticmethod
    def _to_sub(poly, left, up):
        p = np.asarray(poly, np.float64).copy()
        p[0::2] = np.floor(p[0::2] - left)
        p[1::2] = np.floor(p[1::2] - up)
        return p

    @staticmethod
    def _fmt(poly, name, difficult):
        return " ".join(str(float(v)) for v in poly) \
            + f" {name} {difficult}\n"

    def _save_window(self, img, objects, subimgname, left, up, right,
                     down):
        """One window's labelTxt (when the split has labels) and PNG;
        returns the seconds of (cut, labels, encode)."""
        t0 = time.perf_counter()
        lines = (self.tile_labels(objects, left, up, right, down)
                 if self.process_label else None)
        t1 = time.perf_counter()
        if lines is not None:
            with open(os.path.join(self.outlabelpath, subimgname + ".txt"),
                      "w") as f:
                f.writelines(lines)
        sub = img[up:up + self.subsize, left:left + self.subsize]
        if self.padding:
            h, w = sub.shape[:2]
            canvas = np.zeros((self.subsize, self.subsize, 3), sub.dtype)
            canvas[:h, :w] = sub
            sub = canvas
        tile = Image.fromarray(np.ascontiguousarray(sub))
        t2 = time.perf_counter()
        tile.save(os.path.join(self.outimagepath, subimgname + self.ext),
                  compress_level=1)
        return t2 - t1, t1 - t0, time.perf_counter() - t2

    def _decode(self, name, extent):
        """The scene as uint8 RGB, or None where there is no such file."""
        path = os.path.join(self.imagepath, name + extent)
        if not os.path.exists(path):
            return None
        with Image.open(path) as im:
            return np.array(im.convert("RGB"))

    def SplitSingle(self, name, rate, img, pool):
        """Split one decoded scene (uint8 RGB) at one rate: the windows
        go to ``pool`` (a ``ThreadPoolExecutor``); returns their futures
        (``collect`` them)."""
        t0 = time.perf_counter()
        objects = []
        if self.process_label:
            objects = parse_dota_poly(
                os.path.join(self.labelpath, name + ".txt"))
            for obj in objects:
                obj["poly"] = [rate * x for x in obj["poly"]]
                xs, ys = obj["poly"][0::2], obj["poly"][1::2]
                obj["box"] = (min(xs), min(ys), max(xs), max(ys))
        t1 = time.perf_counter()
        if rate != 1:
            scene = torch.from_numpy(img).to(self.device)
            img = resize_cubic_rate(scene, rate).cpu().numpy()
            del scene
        t2 = time.perf_counter()
        self.stats["decode"] += t1 - t0
        self.stats["resize"] += t2 - t1
        self.stats["scenes"] += 1
        outbase = f"{name}__{rate}__"
        height, width = img.shape[:2]
        windows = []
        left = 0
        while left < width:
            if left + self.subsize >= width:
                left = max(width - self.subsize, 0)
            up = 0
            while up < height:
                if up + self.subsize >= height:
                    up = max(height - self.subsize, 0)
                right = min(left + self.subsize, width - 1)
                down = min(up + self.subsize, height - 1)
                windows.append((img, objects, f"{outbase}{left}___{up}",
                                left, up, right, down))
                if up + self.subsize >= height:
                    break
                up += self.slide
            if left + self.subsize >= width:
                break
            left += self.slide
        return [pool.submit(self._save_window, *w) for w in windows]

    def collect(self, futures):
        """Wait for window futures; a worker's error raises here."""
        t0 = time.perf_counter()
        done = [f.result() for f in futures]
        self.stats["wait"] += time.perf_counter() - t0
        for key, k in (("cut", 0), ("labels", 1), ("encode", 2)):
            self.stats[key] += sum(d[k] for d in done)
        self.stats["windows"] += len(done)

    def split_rates(self, rates):
        """Every scene at every rate. A scene is decoded once for all its
        rates; the pool cuts, labels and encodes its windows while the
        parent decodes and resizes the next scene (one scene in
        flight)."""
        names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(self.imagepath)
            if not f.startswith("Thumbs"))
        with ThreadPoolExecutor(max(self.num_process, 1)) as pool:
            pending = []
            for name in names:
                t0 = time.perf_counter()
                img = self._decode(name, self.ext)
                self.stats["decode"] += time.perf_counter() - t0
                if img is None:
                    continue
                futures = [f for rate in rates for f in self.SplitSingle(
                    name, rate, img, pool)]
                self.collect(pending)
                pending = futures
            self.collect(pending)


def process(src_path, target_path, gap=200, subsize=1024, rates=(1.0,),
            num_process=8, device=None, **kw):
    """Pipeline entry: the output dir is suffixed
    ``_<subsize>_<gap>_<rates>``. ``device``: where the resize runs; None
    is the CUDA card (an error where there is none). Prints one JSON line
    of the split's ``stats``."""
    target_path = (f"{target_path}_{subsize}_{gap}_"
                   + "-".join(str(r) for r in rates))
    os.makedirs(target_path, exist_ok=True)
    split = splitbase(src_path, target_path, gap=gap, subsize=subsize,
                      num_process=num_process, device=device, **kw)
    split.split_rates(rates)
    print("img_split " + json.dumps(dict(
        out=target_path, device=str(split.device), **split.stats)),
        flush=True)
    return target_path
