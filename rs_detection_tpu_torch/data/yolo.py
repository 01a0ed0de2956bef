"""The YOLO dataset and the COCO dataset on it (counterpart of
``rs_detection_tpu/data/yolo.py``, all of it but ``LVISDataset``, which
waits for the YOLO family, ROADMAP.md, Queue 1, item 11f): 4- and
9-image mosaic, the YOLO random perspective warp with
``box_candidates``, beta(8, 8) mixup, cutout, letterbox, HSV jitter and
flips; boxes are plain hbbs. Images decode through Pillow and every
OpenCV call of the JAX module goes through ``cv_ops``, its numpy twins,
so the port needs no cv2. The draws come from ``py_random()`` /
``np_random()`` in the JAX module's order: one seed gives the same
samples in both.

``COCODataset`` reads a COCO json as the JAX class does and sets the
attributes the JAX class never sets, because its ``__init__`` does not
call ``YoloDataset.__init__`` (``stride`` 32, no perspective, no mixup,
mosaic-9 or cutout; the JAX ``__getitem__`` raises ``AttributeError``
for want of them). It keeps the JAX arguments ``images_dir`` and
``annotations_file``: the zoo's ``root`` / ``anno_file`` do not reach
it, in either package. As in JAX it ignores ``transforms`` and
letterboxes to ``img_size`` (640 unless given) with pixels in [0, 1].
``batches`` takes the runner's ``flip_mode`` (None only: flip TTA is
not defined here), which the JAX method does not take, and ``evaluate``
takes the runner's (detections, meta) pairs, where the JAX method
unpacks three values an image and raises (ROADMAP.md, Queue 3).

A letterboxed sample (no mosaic, perspective or flip) records the
letterbox in its target, ``letterbox`` = (r, dw, dh): its boxes are the
image's times r plus (dw, dh). ``Runner.postprocess_dense`` undoes it on
the detections, so that they come out in the image's own frame, the
frame of ``img_infos``' ground truth."""

from __future__ import annotations

import json
import math
import os
import pickle

import numpy as np

from ..ops.box_ops import rotated_box_to_bbox_np
from ..utils.registry import DATASETS, register_unported
from . import cv_ops
from .collate import collate_batch
from .devkits.voc_eval import voc_ap
from .io import load_rgb_array
from .transforms import np_random, py_random

GREY = (114, 114, 114)


def augment_hsv(img, hgain=0.015, sgain=0.7, vgain=0.4):
    """Random gains of hue, saturation and value through uint8 tables."""
    r = np_random().uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = cv_ops.rgb2hsv(img)
    x = np.arange(0, 256, dtype=np.int16)
    lut_hue = ((x * r[0]) % 180).astype(img.dtype)
    lut_sat = np.clip(x * r[1], 0, 255).astype(img.dtype)
    lut_val = np.clip(x * r[2], 0, 255).astype(img.dtype)
    return cv_ops.hsv2rgb(np.stack([lut_hue[hsv[..., 0]],
                                    lut_sat[hsv[..., 1]],
                                    lut_val[hsv[..., 2]]], -1))


def box_candidates(box1, box2, wh_thr=2, ar_thr=20, area_thr=0.1):
    """Warped boxes that stay box-like: box1 / box2 [4, n] before and
    after the transform."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + 1e-16), h2 / (w2 + 1e-16))
    return ((w2 > wh_thr) & (h2 > wh_thr)
            & (w2 * h2 / (w1 * h1 + 1e-16) > area_thr) & (ar < ar_thr))


def yolo_random_perspective(img, boxes, labels, degrees=10,
                            translate=0.1, scale=0.1, shear=10,
                            perspective=0.0, border=(0, 0)):
    """The YOLO warp: center, perspective, rotation and scale, shear,
    translation composed; the image warped (grey border), every hbb's
    corners mapped, their hull clipped and kept by ``box_candidates``."""
    rnd = py_random()
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2
    c_m = np.eye(3)
    c_m[0, 2] = -img.shape[1] / 2
    c_m[1, 2] = -img.shape[0] / 2
    p_m = np.eye(3)
    p_m[2, 0] = rnd.uniform(-perspective, perspective)
    p_m[2, 1] = rnd.uniform(-perspective, perspective)
    r_m = np.eye(3)
    a = rnd.uniform(-degrees, degrees)
    s = rnd.uniform(1 - scale, 1 + scale)
    r_m[:2] = cv_ops.rotation_matrix_2d((0, 0), a, s)
    s_m = np.eye(3)
    s_m[0, 1] = math.tan(rnd.uniform(-shear, shear) * math.pi / 180)
    s_m[1, 0] = math.tan(rnd.uniform(-shear, shear) * math.pi / 180)
    t_m = np.eye(3)
    t_m[0, 2] = rnd.uniform(0.5 - translate, 0.5 + translate) * width
    t_m[1, 2] = rnd.uniform(0.5 - translate, 0.5 + translate) * height

    m = t_m @ s_m @ r_m @ p_m @ c_m
    if (border[0] != 0) or (border[1] != 0) or (m != np.eye(3)).any():
        if perspective:
            img = cv_ops.warp_perspective(img, m, (width, height))
        else:
            img = cv_ops.warp_affine(img, m[:2], (width, height))

    n = len(boxes)
    if n:
        xy = np.ones((n * 4, 3))
        xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
        xy = xy @ m.T
        xy = (xy[:, :2] / xy[:, 2:3] if perspective
              else xy[:, :2]).reshape(n, 8)
        x = xy[:, [0, 2, 4, 6]]
        y = xy[:, [1, 3, 5, 7]]
        new = np.concatenate((x.min(1), y.min(1), x.max(1),
                              y.max(1))).reshape(4, n).T
        new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
        new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
        keep = box_candidates(box1=boxes.T * s, box2=new.T)
        boxes = new[keep].astype(np.float32)
        labels = labels[keep]
    return img, boxes, labels


def letterbox(img, new_shape=640, color=GREY, auto=True,
              scale_fill=False, scaleup=True, stride=32):
    """Resize keeping the aspect and pad to ``new_shape`` (with ``auto``
    only to the next multiple of ``stride``). Returns (img, (rw, rh),
    (dw, dh))."""
    shape = img.shape[:2]
    if isinstance(new_shape, int):
        new_shape = (new_shape, new_shape)
    r = min(new_shape[0] / shape[0], new_shape[1] / shape[1])
    if not scaleup:
        r = min(r, 1.0)
    ratio = (r, r)
    new_unpad = (int(round(shape[1] * r)), int(round(shape[0] * r)))
    dw = new_shape[1] - new_unpad[0]
    dh = new_shape[0] - new_unpad[1]
    if auto:
        dw, dh = dw % stride, dh % stride
    elif scale_fill:
        dw, dh = 0, 0
        new_unpad = (new_shape[1], new_shape[0])
        ratio = (new_shape[1] / shape[1], new_shape[0] / shape[0])
    dw /= 2
    dh /= 2
    if shape[::-1] != new_unpad:
        img = cv_ops.resize_linear(img, new_unpad)
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    img = cv_ops.copy_make_border(img, top, bottom, left, right, color)
    return img, ratio, (dw, dh)


def cutout(img, boxes):
    """Random grey-level occlusions in place; returns the mask of the
    boxes less than 60% covered by the larger ones."""
    rnd = py_random()
    h, w = img.shape[:2]

    def bbox_ioa(box1, box2):
        box2 = box2.T
        ix = (np.minimum(box1[2], box2[2])
              - np.maximum(box1[0], box2[0])).clip(0)
        iy = (np.minimum(box1[3], box2[3])
              - np.maximum(box1[1], box2[1])).clip(0)
        area = ((box2[2] - box2[0]) * (box2[3] - box2[1]) + 1e-16)
        return ix * iy / area

    keep = np.ones((len(boxes),), bool)
    scales = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 \
        + [0.03125] * 16
    for sc in scales:
        mask_h = rnd.randint(1, int(h * sc))
        mask_w = rnd.randint(1, int(w * sc))
        xmin = max(0, rnd.randint(0, w) - mask_w // 2)
        ymin = max(0, rnd.randint(0, h) - mask_h // 2)
        xmax = min(w, xmin + mask_w)
        ymax = min(h, ymin + mask_h)
        img[ymin:ymax, xmin:xmax] = [rnd.randint(64, 191) for _ in range(3)]
        if len(boxes) and sc > 0.03:
            ioa = bbox_ioa(np.asarray([xmin, ymin, xmax, ymax], np.float32),
                           boxes)
            keep &= ioa < 0.60
    return keep


@DATASETS.register_module()
class YoloDataset:
    """A ``labels.pkl`` dataset (``dataset_dir`` with ``images/``, or
    ``images_dir`` and ``annotations_file``) with hbb annotations (an
    rbox annotation becomes its enclosing hbb), served as fixed-size
    square images in [0, 1]: mosaic, or letterbox to ``img_size``."""

    def __init__(self, images_dir=None, annotations_file=None,
                 dataset_dir=None, img_size=640, batch_size=8,
                 num_workers=0, shuffle=True, mosaic=True,
                 hsv=True, flip=True, max_gt=512,
                 random_perspective=None, mixup_prob=0.0,
                 mosaic9_prob=0.0, cutout_prob=0.0, stride=32, **kw):
        if dataset_dir is not None:
            images_dir = os.path.join(dataset_dir, "images")
            annotations_file = os.path.join(dataset_dir, "labels.pkl")
        self.images_dir = images_dir
        with open(annotations_file, "rb") as f:
            self.img_infos = pickle.load(f)
        self.img_size = img_size
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.mosaic = mosaic
        self.hsv = hsv
        self.flip = flip
        self.max_gt = max_gt
        # dict(degrees=, translate=, scale=, shear=, perspective=) or None
        if random_perspective is not None:
            random_perspective = {k: v for k, v in
                                  dict(random_perspective).items()
                                  if k != "type"}
        self.random_perspective = random_perspective
        self.mixup_prob = mixup_prob
        self.mosaic9_prob = mosaic9_prob
        self.cutout_prob = cutout_prob
        self.stride = stride
        self.total_len = len(self.img_infos)

    def __len__(self):
        return self.total_len

    def _load(self, idx):
        info = self.img_infos[idx]
        img = load_rgb_array(os.path.join(self.images_dir, info["filename"]))
        ann = info.get("ann", {})
        boxes = np.asarray(ann.get("hboxes",
                                   ann.get("bboxes", np.zeros((0, 4)))),
                           np.float32)
        if boxes.size and boxes.shape[1] == 5:
            boxes, _ = rotated_box_to_bbox_np(boxes)
        labels = np.asarray(ann.get("labels", np.zeros((0,))), np.int32)
        return img, boxes, labels

    def _mosaic4(self, idx):
        rnd = py_random()
        s = self.img_size
        yc = int(rnd.uniform(s // 2, 3 * s // 2))
        xc = int(rnd.uniform(s // 2, 3 * s // 2))
        idxs = [idx] + [rnd.randint(0, self.total_len - 1) for _ in range(3)]
        canvas = np.full((2 * s, 2 * s, 3), 114, np.uint8)
        all_boxes, all_labels = [], []
        for i, ix in enumerate(idxs):
            img, boxes, labels = self._load(ix)
            h, w = img.shape[:2]
            r = s / max(h, w)
            img = cv_ops.resize_linear(img, (int(w * r), int(h * r)))
            h, w = img.shape[:2]
            if i == 0:
                x1a, y1a = max(xc - w, 0), max(yc - h, 0)
                x2a, y2a = xc, yc
            elif i == 1:
                x1a, y1a = xc, max(yc - h, 0)
                x2a, y2a = min(xc + w, 2 * s), yc
            elif i == 2:
                x1a, y1a = max(xc - w, 0), yc
                x2a, y2a = xc, min(yc + h, 2 * s)
            else:
                x1a, y1a = xc, yc
                x2a, y2a = min(xc + w, 2 * s), min(yc + h, 2 * s)
            x1b = w - (x2a - x1a) if i in (0, 2) else 0
            y1b = h - (y2a - y1a) if i in (0, 1) else 0
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a),
                                           x1b:x1b + (x2a - x1a)]
            if boxes.size:
                b = boxes * r
                b[:, 0::2] += x1a - x1b
                b[:, 1::2] += y1a - y1b
                all_boxes.append(b)
                all_labels.append(labels)
        boxes = (np.concatenate(all_boxes)
                 if all_boxes else np.zeros((0, 4), np.float32))
        labels = (np.concatenate(all_labels)
                  if all_labels else np.zeros((0,), np.int32))
        return self._finish_mosaic(canvas, boxes, labels)

    def _finish_mosaic(self, canvas, boxes, labels):
        """The oversized mosaic canvas to s x s: through the random
        perspective with a negative border where the config has one, else
        the center crop (the warp's identity case)."""
        s = self.img_size
        if self.random_perspective is not None:
            np.clip(boxes[:, 0::2], 0, canvas.shape[1], out=boxes[:, 0::2])
            np.clip(boxes[:, 1::2], 0, canvas.shape[0], out=boxes[:, 1::2])
            border = ((s - canvas.shape[0]) // 2,
                      (s - canvas.shape[1]) // 2)
            return yolo_random_perspective(
                canvas, boxes, labels, border=border,
                **self.random_perspective)
        off = (canvas.shape[0] - s) // 2
        canvas = canvas[off:off + s, off:off + s]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2] - off, 0, s - 1)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2] - off, 0, s - 1)
        keep = ((boxes[:, 2] - boxes[:, 0] > 2)
                & (boxes[:, 3] - boxes[:, 1] > 2))
        return canvas, boxes[keep], labels[keep]

    def _mosaic9(self, idx):
        """9-image mosaic: tiles chained clockwise around a center image
        on a 3s x 3s canvas (each placed off the tile before's size), a
        random 2s x 2s crop, then reduced as mosaic-4."""
        rnd = py_random()
        s = self.img_size
        idxs = [idx] + [rnd.randint(0, self.total_len - 1) for _ in range(8)]
        canvas = np.full((3 * s, 3 * s, 3), 114, np.uint8)
        all_boxes, all_labels = [], []
        hp = wp = h0 = w0 = -1
        for i, ix in enumerate(idxs):
            img, boxes, labels = self._load(ix)
            ih, iw = img.shape[:2]
            r = s / max(ih, iw)
            img = cv_ops.resize_linear(img, (int(iw * r), int(ih * r)))
            h, w = img.shape[:2]
            if i == 0:        # center
                h0, w0 = h, w
                c = (s, s, s + w, s + h)
            elif i == 1:      # top
                c = (s, s - h, s + w, s)
            elif i == 2:      # top right
                c = (s + wp, s - h, s + wp + w, s)
            elif i == 3:      # right
                c = (s + w0, s, s + w0 + w, s + h)
            elif i == 4:      # bottom right
                c = (s + w0, s + hp, s + w0 + w, s + hp + h)
            elif i == 5:      # bottom
                c = (s + w0 - w, s + hp, s + w0, s + hp + h)
            elif i == 6:      # bottom left
                c = (s + w0 - wp - w, s + hp, s + w0 - wp, s + hp + h)
            elif i == 7:      # left
                c = (s - w, s + h0 - h, s, s + h0)
            else:             # top left
                c = (s - w, s + h0 - hp - h, s, s + h0 - hp)
            padx, pady = c[0], c[1]
            x1, y1, x2, y2 = (max(v, 0) for v in c)
            x2, y2 = min(x2, 3 * s), min(y2, 3 * s)
            if x2 > x1 and y2 > y1:
                canvas[y1:y2, x1:x2] = img[y1 - pady:y2 - pady,
                                           x1 - padx:x2 - padx]
            hp, wp = h, w
            if boxes.size:
                b = boxes * r
                b[:, 0::2] += padx
                b[:, 1::2] += pady
                all_boxes.append(b)
                all_labels.append(labels)
        yc = int(rnd.uniform(0, s))
        xc = int(rnd.uniform(0, s))
        canvas = canvas[yc:yc + 2 * s, xc:xc + 2 * s]
        boxes = (np.concatenate(all_boxes)
                 if all_boxes else np.zeros((0, 4), np.float32))
        labels = (np.concatenate(all_labels)
                  if all_labels else np.zeros((0,), np.int32))
        if boxes.size:
            boxes[:, 0::2] = np.clip(boxes[:, 0::2] - xc, 0, 2 * s)
            boxes[:, 1::2] = np.clip(boxes[:, 1::2] - yc, 0, 2 * s)
            ok = ((boxes[:, 2] - boxes[:, 0] > 2)
                  & (boxes[:, 3] - boxes[:, 1] > 2))
            boxes, labels = boxes[ok], labels[ok]
        return self._finish_mosaic(canvas, boxes, labels)

    def _mosaic_sample(self, idx):
        if self.mosaic9_prob > 0 and py_random().random() < self.mosaic9_prob:
            return self._mosaic9(idx)
        return self._mosaic4(idx)

    def __getitem__(self, idx):
        rnd = py_random()
        frame = None
        if self.mosaic:
            img, boxes, labels = self._mosaic_sample(idx)
            if self.mixup_prob > 0 and rnd.random() < self.mixup_prob:
                img2, boxes2, labels2 = self._mosaic_sample(
                    rnd.randint(0, self.total_len - 1))
                r = np_random().beta(8.0, 8.0)
                img = (img.astype(np.float32) * r
                       + img2.astype(np.float32) * (1 - r)).astype(np.uint8)
                boxes = np.concatenate([boxes, boxes2], 0)
                labels = np.concatenate([labels, labels2], 0)
        else:
            img, boxes, labels = self._load(idx)
            img, ratio, (dw, dh) = letterbox(
                img, self.img_size, auto=False, stride=self.stride)
            boxes = boxes.copy()
            if boxes.size:
                boxes[:, 0::2] = boxes[:, 0::2] * ratio[0] + dw
                boxes[:, 1::2] = boxes[:, 1::2] * ratio[1] + dh
            if self.random_perspective is not None:
                img, boxes, labels = yolo_random_perspective(
                    img, boxes, labels, **self.random_perspective)
            else:
                frame = (ratio[0], dw, dh)
        if self.hsv:
            img = augment_hsv(img)
        if self.cutout_prob > 0 and rnd.random() < self.cutout_prob:
            img = np.ascontiguousarray(img)
            keep = cutout(img, boxes)
            boxes, labels = boxes[keep], labels[keep]
        if self.flip and rnd.random() < 0.5:
            img = img[:, ::-1]
            boxes = boxes.copy()
            w = img.shape[1]
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
            frame = None
        target = dict(hboxes=boxes.astype(np.float32),
                      labels=labels, scale_factor=1.0,
                      img_size=(img.shape[1], img.shape[0]))
        if frame is not None:
            target["letterbox"] = frame
        return (np.ascontiguousarray(img, np.float32) / 255.0, target)

    def batches(self, seed=None, flip_mode=None):
        """Collated batches (images, targets, metas) in order, shuffled by
        ``RandomState(seed)`` when ``shuffle``; the last may be short.
        ``flip_mode`` must be None (the runner's test task passes it)."""
        if flip_mode is not None:
            raise ValueError(f"{type(self).__name__}: flip TTA "
                             f"({flip_mode!r}) is not defined")
        order = np.arange(self.total_len)
        if self.shuffle:
            np.random.RandomState(seed).shuffle(order)
        nb = -(-self.total_len // self.batch_size)
        for bi in range(nb):
            idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            samples, metas = [], []
            for i in idxs:
                img, tgt = self[int(i)]
                samples.append((img, tgt))
                metas.append(tgt)
            yield (*collate_batch(samples, self.max_gt), metas)

    prefetch = batches


@DATASETS.register_module()
class COCODataset(YoloDataset):
    """COCO-format hbbs (reference ``coco.py:24``): the json's images in
    its order, the sorted category ids as labels 1..K, crowd boxes
    dropped; no mosaic, HSV or flip unless asked."""

    def __init__(self, images_dir=None, annotations_file=None, **kw):
        with open(annotations_file) as f:
            coco = json.load(f)
        imgs = {im["id"]: im for im in coco["images"]}
        cats = sorted(c["id"] for c in coco["categories"])
        cat_map = {cid: i + 1 for i, cid in enumerate(cats)}
        anns = {}
        for a in coco["annotations"]:
            if a.get("iscrowd"):
                continue
            x, y, w, h = a["bbox"]
            anns.setdefault(a["image_id"], []).append(
                ([x, y, x + w, y + h], cat_map[a["category_id"]]))
        self.img_infos = []
        for iid, im in imgs.items():
            items = anns.get(iid, [])
            self.img_infos.append(dict(
                filename=im["file_name"], width=im["width"],
                height=im["height"],
                ann=dict(hboxes=np.asarray([b for b, _ in items],
                                           np.float32).reshape(-1, 4),
                         labels=np.asarray([c for _, c in items],
                                           np.int32))))
        self.images_dir = images_dir
        self.img_size = kw.get("img_size", 640)
        self.batch_size = kw.get("batch_size", 8)
        self.shuffle = kw.get("shuffle", False)
        self.mosaic = kw.get("mosaic", False)
        self.hsv = kw.get("hsv", False)
        self.flip = kw.get("flip", False)
        self.max_gt = kw.get("max_gt", 512)
        self.total_len = len(self.img_infos)
        # what YoloDataset.__init__ would have set (the JAX class never
        # sets them and its __getitem__ raises)
        self.stride = 32
        self.random_perspective = None
        self.mixup_prob = self.mosaic9_prob = self.cutout_prob = 0.0

    def evaluate(self, results, work_dir=None, epoch=0, logger=None):
        """COCO-style hbb mAP without pycocotools: for each class and IoU
        threshold 0.50:0.95:0.05, detections by descending score matched
        greedily to the image's unused ground truths, the 101-point-free
        VOC area AP; mean over both, AP50 and per-class AP50.

        Args:
          results: one ((polys [N, 8], scores [N], labels [N], 1-based),
            meta) pair an image, in the order of ``img_infos``: the
            runner's, the polygons in the image's own frame. Their
            enclosing hbbs are scored.
        """
        iou_thrs = np.arange(0.5, 1.0, 0.05)
        classes = getattr(self, "CLASSES", None)
        n_cls = len(classes) if classes else int(
            max((int(i["ann"]["labels"].max())
                 for i in self.img_infos
                 if len(i["ann"]["labels"])), default=0))
        aps = np.zeros((len(iou_thrs), n_cls))
        for ci in range(1, n_cls + 1):
            gts, dets = [], []
            for ii, info in enumerate(self.img_infos):
                m = info["ann"]["labels"] == ci
                gts.append(info["ann"]["hboxes"][m])
                if ii < len(results):
                    (p, s, lab), _ = results[ii]
                    dm = np.asarray(lab) == ci
                    xy = np.asarray(p)[dm].reshape(-1, 4, 2)
                    dets.append((ii, np.concatenate([xy.min(1), xy.max(1)],
                                                    1), np.asarray(s)[dm]))
            flat = np.concatenate(
                [np.concatenate([np.full((len(s), 1), ii), b, s[:, None]], 1)
                 for ii, b, s in dets if len(s)] or [np.zeros((0, 6))])
            flat = flat[np.argsort(-flat[:, 5])]
            n_gt = sum(len(g) for g in gts)
            for ti, thr in enumerate(iou_thrs):
                used = [np.zeros(len(g), bool) for g in gts]
                tp = np.zeros(len(flat))
                fp = np.zeros(len(flat))
                for di, row in enumerate(flat):
                    ii = int(row[0])
                    g = gts[ii]
                    if len(g) == 0:
                        fp[di] = 1
                        continue
                    ix = np.maximum(0, np.minimum(g[:, 2], row[3])
                                    - np.maximum(g[:, 0], row[1]))
                    iy = np.maximum(0, np.minimum(g[:, 3], row[4])
                                    - np.maximum(g[:, 1], row[2]))
                    inter = ix * iy
                    area_d = (row[3] - row[1]) * (row[4] - row[2])
                    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
                    iou = inter / np.maximum(area_d + area_g - inter, 1e-9)
                    j = int(np.argmax(iou))
                    if iou[j] >= thr and not used[ii][j]:
                        tp[di] = 1
                        used[ii][j] = True
                    else:
                        fp[di] = 1
                rec = np.cumsum(tp) / max(n_gt, 1)
                prec = np.cumsum(tp) / np.maximum(
                    np.cumsum(tp) + np.cumsum(fp), 1e-9)
                aps[ti, ci - 1] = voc_ap(rec, prec, use_07_metric=False)
        out = {"eval/mAP": float(aps.mean()),
               "eval/AP50": float(aps[0].mean()),
               "per_class_ap50": [float(a) for a in aps[0]]}
        if logger is not None:
            logger.log({k: v for k, v in out.items()
                        if not isinstance(v, list)})
        return out


# LVIS (its 1203-category table and long-tail protocol) waits for 11f
register_unported(DATASETS, ("LVISDataset",), "the dataset", "11f")
