"""Host-side transforms (counterpart of ``Compose``, ``Resize``,
``RotatedResize``, ``Pad``, ``Normalize`` and the training augmentations
``RandomFlip``, ``RotatedRandomFlip``, ``RandomRotateAug``, ``RandmNoise``
and ``RandmGrayScale``, and SSD's ``MinIoURandomCrop``, ``Expand``,
``PhotoMetricDistortion`` and ``Resize_keep_ratio`` in
``rs_detection_tpu/data/transforms.py``): PIL + numpy, before batching.
``Normalize`` emits float32 HWC arrays, so
batches are NHWC. The augmentations draw from Python's ``random`` and
from ``np.random`` in the JAX package's order, so one seed gives the
same augmentation in both; inside ``own_draws(seed)`` the thread that
runs them draws from a generator pair of its own instead (the threaded
loader's samples, ``data/custom.py``). ``PhotoMetricDistortion``
converts to HSV and back through ``cv_ops``, the numpy twins of the
OpenCV calls of the JAX transform."""

from __future__ import annotations

import contextlib
import random
import threading

import numpy as np
from PIL import Image

from ..ops.box_ops import (norm_angle, poly_to_rotated_box_np,
                           rotated_box_to_poly_np)
from ..utils.registry import TRANSFORMS, build_from_cfg
from . import cv_ops

_DRAWS = threading.local()


def py_random():
    """The ``random``-like source this thread's augmentations draw from."""
    return getattr(_DRAWS, "py", random)


def np_random():
    """The ``np.random``-like source this thread's augmentations draw
    from."""
    return getattr(_DRAWS, "np", np.random)


@contextlib.contextmanager
def own_draws(seed: int):
    """Inside, this thread draws from ``random.Random(seed)`` and
    ``np.random.RandomState(seed)`` instead of the global generators, so
    what a sample draws does not depend on the other threads."""
    _DRAWS.py, _DRAWS.np = random.Random(seed), np.random.RandomState(seed)
    try:
        yield
    finally:
        del _DRAWS.py, _DRAWS.np


_BOX_KEYS = ["bboxes", "hboxes", "rboxes", "polys",
             "hboxes_ignore", "polys_ignore", "rboxes_ignore"]


@TRANSFORMS.register_module()
class Compose:
    def __init__(self, transforms=None):
        self.transforms = []
        for t in (transforms or []):
            if isinstance(t, dict):
                t = build_from_cfg(t, TRANSFORMS)
            elif not callable(t):
                raise TypeError("transform must be callable or a dict")
            self.transforms.append(t)

    def __call__(self, image, target=None):
        for t in self.transforms:
            image, target = t(image, target)
        return image, target


@TRANSFORMS.register_module()
class Resize:
    """Resize so the short side is one of ``min_size`` (clipped to
    [2/3, 3/2] of it) and the long side at most ``max_size``."""

    def __init__(self, min_size, max_size, keep_ratio=True):
        self.min_size = (tuple(min_size)
                         if isinstance(min_size, (list, tuple))
                         else (min_size,))
        self.max_size = max_size
        self.keep_ratio = keep_ratio

    def get_size(self, image_size):
        w, h = image_size
        size = py_random().choice(self.min_size)
        if not self.keep_ratio:
            return (self.min_size[0], self.max_size), self.min_size[0] / h
        if w <= h:
            size = int(np.clip(size, int(w / 1.5), int(w * 1.5)))
        else:
            size = int(np.clip(size, int(h / 1.5), int(h * 1.5)))
        if self.max_size is not None:
            mn, mx = float(min(w, h)), float(max(w, h))
            if mx / mn * size > self.max_size:
                size = int(round(self.max_size * mn / mx))
        if (w <= h and w == size) or (h <= w and h == size):
            return (h, w), 1.0
        if w < h:
            ow, oh = size, int(size * h / w)
        else:
            oh, ow = size, int(size * w / h)
        return (oh, ow), oh / h

    def _resize_boxes(self, target, size):
        w0, h0 = target["img_size"]
        nw, nh = size
        for key in ["bboxes", "polys"]:
            if target.get(key) is None:
                continue
            b = target[key].astype(np.float32)
            b[:, 0::2] = np.clip(b[:, 0::2] * (nw / w0), 0, nw - 1)
            b[:, 1::2] = np.clip(b[:, 1::2] * (nh / h0), 0, nh - 1)
            target[key] = b

    def __call__(self, image, target=None):
        (oh, ow), scale = self.get_size(image.size)
        image = image.resize((ow, oh), Image.BILINEAR)
        if target is not None:
            self._resize_boxes(target, image.size)
            target["img_size"] = image.size
            target["scale_factor"] = scale
            target["pad_shape"] = image.size
            target["keep_ratio"] = self.keep_ratio
        return image, target


@TRANSFORMS.register_module()
class RotatedResize(Resize):
    """Resize that carries rotated boxes through their polygons."""

    def __init__(self, min_size, max_size, angle_version="le135",
                 keep_ratio=True):
        super().__init__(min_size, max_size, keep_ratio)
        self.angle_version = angle_version

    def _resize_boxes(self, target, size):
        w0, h0 = target["img_size"]
        nw, nh = size
        for key in _BOX_KEYS:
            b = target.get(key)
            if b is None or getattr(b, "ndim", 0) != 2 or b.shape[0] == 0:
                continue
            b = b.astype(np.float32)
            is_rbox = "rboxes" in key
            if is_rbox:
                b = rotated_box_to_poly_np(b, self.angle_version)
            b[:, 0::2] = np.clip(b[:, 0::2] * (nw / w0), 0, nw - 1)
            b[:, 1::2] = np.clip(b[:, 1::2] * (nh / h0), 0, nh - 1)
            if is_rbox:
                b = poly_to_rotated_box_np(b, self.angle_version)
            target[key] = b


@TRANSFORMS.register_module()
class Pad:
    """Pad on the right and bottom with ``pad_val`` to ``size`` (w, h) or
    to multiples of ``size_divisor``."""

    def __init__(self, size=None, size_divisor=None, pad_val=0):
        if (size is None) == (size_divisor is None):
            raise ValueError("Pad takes one of size and size_divisor")
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, image, target=None):
        if self.size is not None:
            pw, ph = self.size
        else:
            ph = int(np.ceil(image.size[1] / self.size_divisor)) \
                * self.size_divisor
            pw = int(np.ceil(image.size[0] / self.size_divisor)) \
                * self.size_divisor
        new_image = Image.new(image.mode, (pw, ph),
                              (self.pad_val,) * len(image.split()))
        new_image.paste(image, (0, 0, image.size[0], image.size[1]))
        if target is not None:
            target["pad_shape"] = new_image.size
        return new_image, target


@TRANSFORMS.register_module()
class Normalize:
    """-> float32 HWC array, ``(x - mean) / std`` per channel (RGB, or
    BGR with ``to_bgr``)."""

    def __init__(self, mean, std, to_bgr=True):
        self.mean = np.asarray(mean, np.float32).reshape(1, 1, -1)
        self.std = np.asarray(std, np.float32).reshape(1, 1, -1)
        self.to_bgr = to_bgr

    def __call__(self, image, target=None):
        if isinstance(image, Image.Image):
            image = np.asarray(image, np.float32)
        image = image.astype(np.float32)
        if self.to_bgr:
            image = image[..., ::-1]
        image = (image - self.mean) / self.std
        if target is not None:
            target["to_bgr"] = self.to_bgr
        return image, target


@TRANSFORMS.register_module()
class RandomFlip:
    """Flip with probability ``prob`` (one ``random()`` draw per call):
    the image, and the hboxes (``bboxes``, ``hboxes``, ``hboxes_ignore``)
    as x -> w - x."""

    def __init__(self, prob=0.5, direction="horizontal"):
        if direction not in ("horizontal", "vertical", "diagonal"):
            raise ValueError(f"RandomFlip: unknown direction {direction!r}")
        self.prob = prob
        self.direction = direction

    def _flip_image(self, image):
        if self.direction == "horizontal":
            return image.transpose(Image.FLIP_LEFT_RIGHT)
        if self.direction == "vertical":
            return image.transpose(Image.FLIP_TOP_BOTTOM)
        return image.transpose(Image.FLIP_LEFT_RIGHT) \
                    .transpose(Image.FLIP_TOP_BOTTOM)

    def _flip_boxes(self, target, size):
        w, h = size
        for key in ["bboxes", "hboxes", "hboxes_ignore"]:
            b = target.get(key)
            if b is None or b.shape[0] == 0:
                continue
            target[key] = self._flip_hbb(b, w, h)

    def _flip_hbb(self, b, w, h):
        f = b.copy()
        if self.direction in ("horizontal", "diagonal"):
            f[..., 0::4] = w - b[..., 2::4]
            f[..., 2::4] = w - b[..., 0::4]
        if self.direction in ("vertical", "diagonal"):
            f[..., 1::4] = h - b[..., 3::4]
            f[..., 3::4] = h - b[..., 1::4]
        return f

    def __call__(self, image, target=None):
        if py_random().random() < self.prob:
            image = self._flip_image(image)
            if target is not None:
                self._flip_boxes(target, image.size)
                target["flip"] = self.direction
        return image, target


@TRANSFORMS.register_module()
class RotatedRandomFlip(RandomFlip):
    """Flip that also carries rotated boxes and polygons: horizontal x ->
    w - x - 1, theta -> pi - theta; vertical y -> h - y - 1, theta ->
    -theta (le135). A diagonal flip of rotated boxes raises."""

    def _flip_boxes(self, target, size):
        w, h = size
        for key in _BOX_KEYS:
            b = target.get(key)
            if b is None or b.shape[0] == 0:
                continue
            if "rboxes" in key:
                f = b.copy()
                if self.direction == "horizontal":
                    f[..., 0] = w - b[..., 0] - 1
                    f[..., 4] = norm_angle(np.pi - b[..., 4])
                elif self.direction == "vertical":
                    f[..., 1] = h - b[..., 1] - 1
                    f[..., 4] = norm_angle(-b[..., 4])
                else:
                    raise ValueError("RotatedRandomFlip: no diagonal flip "
                                     "of rotated boxes")
            elif "polys" in key:
                f = b.copy()
                if self.direction in ("horizontal", "diagonal"):
                    f[..., 0::2] = w - b[..., 0::2] - 1
                if self.direction in ("vertical", "diagonal"):
                    f[..., 1::2] = h - b[..., 1::2] - 1
            else:
                f = self._flip_hbb(b, w, h)
            target[key] = f


@TRANSFORMS.register_module()
class RandomRotateAug:
    """With ``random_rotate_on``, k x 90-degree anticlockwise rotations,
    k = int(100 * random()) // 25; hboxes map directly, rotated
    boxes through their polygons."""

    def __init__(self, angle_version="le135", random_rotate_on=False):
        self.random_rotate_on = random_rotate_on
        self.angle_version = angle_version

    def _rotate_boxes_90(self, target, size):
        w, _ = size
        for key in _BOX_KEYS + ["bboxes"]:
            b = target.get(key)
            if b is None or getattr(b, "ndim", 0) < 2 or b.shape[0] == 0:
                continue
            if "bboxes" in key or "hboxes" in key:
                nb = np.zeros_like(b)
                nb[:, 0::2] = b[:, 1::2]
                nb[:, 1] = w - b[:, 2]
                nb[:, 3] = w - b[:, 0]
                target[key] = nb
                continue
            is_rbox = "rboxes" in key
            if is_rbox:
                b = rotated_box_to_poly_np(b, self.angle_version)
            nb = np.zeros_like(b)
            nb[:, 0::2] = b[:, 1::2]
            nb[:, 1::2] = w - b[:, 0::2]
            if is_rbox:
                nb = poly_to_rotated_box_np(nb, self.angle_version)
            target[key] = nb

    def __call__(self, image, target=None):
        if self.random_rotate_on:
            k = int(py_random().random() * 100) // 25
            for _ in range(k):
                if target is not None:
                    self._rotate_boxes_90(target, image.size)
                image = image.rotate(90, expand=True)
            if target is not None:
                target["rotate_angle"] = 90 * k
        return image, target


@TRANSFORMS.register_module()
class RandmNoise:
    """With probability ``prob``, uniform noise in [-max_noise, max_noise)
    from ``np.random``, clipped to uint8."""

    def __init__(self, prob=0.3, max_noise=10.0):
        self.prob = prob
        self.max_noise = max_noise

    def __call__(self, image, target=None):
        if py_random().random() < self.prob:
            arr = np.asarray(image, np.float32)
            arr = arr + np_random().uniform(-self.max_noise,
                                            self.max_noise, arr.shape)
            image = Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))
        return image, target


@TRANSFORMS.register_module()
class RandmGrayScale:
    """With probability ``prob``, PIL's grey level copied to RGB."""

    def __init__(self, prob=0.1):
        self.prob = prob

    def __call__(self, image, target=None):
        if py_random().random() < self.prob:
            image = image.convert("L").convert("RGB")
        return image, target


@TRANSFORMS.register_module()
class MinIoURandomCrop:
    """A random crop whose box-covered share of every hbb (``hboxes``) is
    at least a ``min_ious`` draw (1 keeps the image, 0 takes any crop),
    keeping the boxes whose centers it holds (reference
    ``transforms.py:483``). Up to ``max_tries`` crops of 0.3-1 of each
    side and an aspect within [1/2, 2]; none found keeps the image."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                 min_crop_size=0.3, max_tries=50):
        self.min_ious = (1,) + tuple(min_ious) + (0,)
        self.min_crop_size = min_crop_size
        self.max_tries = max_tries

    def __call__(self, image, target=None):
        if target is None or target.get("hboxes") is None \
                or len(target["hboxes"]) == 0:
            return image, target
        rnd = py_random()
        w, h = image.size
        boxes = target["hboxes"]
        min_iou = rnd.choice(self.min_ious)
        if min_iou == 1:
            return image, target
        for _ in range(self.max_tries):
            cw = rnd.uniform(self.min_crop_size * w, w)
            ch = rnd.uniform(self.min_crop_size * h, h)
            if cw / ch < 0.5 or cw / ch > 2:
                continue
            left = rnd.uniform(0, w - cw)
            top = rnd.uniform(0, h - ch)
            patch = np.array([left, top, left + cw, top + ch])
            inter = (np.clip(np.minimum(boxes[:, 2], patch[2])
                             - np.maximum(boxes[:, 0], patch[0]), 0, None)
                     * np.clip(np.minimum(boxes[:, 3], patch[3])
                               - np.maximum(boxes[:, 1], patch[1]), 0, None))
            area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            if (inter / np.maximum(area, 1e-6)).min() < min_iou:
                continue
            ctr = (boxes[:, :2] + boxes[:, 2:4]) / 2
            keep = ((ctr[:, 0] > patch[0]) & (ctr[:, 0] < patch[2])
                    & (ctr[:, 1] > patch[1]) & (ctr[:, 1] < patch[3]))
            if not keep.any():
                continue
            image = image.crop(tuple(int(v) for v in patch))
            for key in _BOX_KEYS + ["labels"]:
                b = target.get(key)
                if b is None or len(b) == 0:
                    continue
                b = b[keep] if len(b) == len(keep) else b
                if key == "labels":
                    target[key] = b
                    continue
                b = b.copy().astype(np.float32)
                if "rboxes" in key:
                    b[:, 0] -= patch[0]
                    b[:, 1] -= patch[1]
                else:
                    b[:, 0::2] -= patch[0]
                    b[:, 1::2] -= patch[1]
                target[key] = b
            target["img_size"] = image.size
            return image, target
        return image, target


@TRANSFORMS.register_module()
class Expand:
    """With probability ``prob``, the image pasted at a random place on a
    ``mean``-filled canvas ``ratio_range`` times its size, the boxes
    moved with it (reference ``transforms.py:556``)."""

    def __init__(self, mean=(123.675, 116.28, 103.53), ratio_range=(1, 4),
                 prob=0.5):
        self.mean = tuple(int(m) for m in mean)
        self.ratio_range = ratio_range
        self.prob = prob

    def __call__(self, image, target=None):
        rnd = py_random()
        if rnd.random() > self.prob:
            return image, target
        w, h = image.size
        ratio = rnd.uniform(*self.ratio_range)
        nw, nh = int(w * ratio), int(h * ratio)
        left = rnd.randint(0, nw - w)
        top = rnd.randint(0, nh - h)
        canvas = Image.new(image.mode, (nw, nh), self.mean)
        canvas.paste(image, (left, top))
        if target is not None:
            for key in _BOX_KEYS + ["bboxes"]:
                b = target.get(key)
                if b is None or len(b) == 0:
                    continue
                b = b.copy().astype(np.float32)
                if "rboxes" in key:
                    b[:, 0] += left
                    b[:, 1] += top
                else:
                    b[:, 0::2] += left
                    b[:, 1::2] += top
                target[key] = b
            target["img_size"] = canvas.size
        return canvas, target


@TRANSFORMS.register_module()
class PhotoMetricDistortion:
    """Brightness and contrast jitter in f32, then saturation and hue in
    OpenCV's uint8 HSV (reference ``transforms.py:583``), each with
    probability 1/2, in the JAX transform's order of draws."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, image, target=None):
        rnd = py_random()
        arr = np.asarray(image, np.float32)
        if rnd.random() < 0.5:
            arr += rnd.uniform(-self.brightness_delta,
                               self.brightness_delta)
        if rnd.random() < 0.5:
            arr *= rnd.uniform(*self.contrast_range)
        hsv = cv_ops.rgb2hsv(np.clip(arr, 0, 255).astype(np.uint8)) \
            .astype(np.float32)
        if rnd.random() < 0.5:
            hsv[..., 1] *= rnd.uniform(*self.saturation_range)
        if rnd.random() < 0.5:
            hsv[..., 0] = (hsv[..., 0] + rnd.uniform(
                -self.hue_delta, self.hue_delta)) % 180
        arr = cv_ops.hsv2rgb(np.clip(hsv, 0, 255).astype(np.uint8))
        return Image.fromarray(arr), target


@TRANSFORMS.register_module()
class Resize_keep_ratio(Resize):
    """``Resize`` with ``keep_ratio`` forced True, as the JAX alias
    forces it whatever the config writes (reference
    ``transforms.py:593``; both SSD configs write ``keep_ratio=False``,
    ROADMAP.md, "Known inexact spots")."""

    def __init__(self, min_size, max_size, **kw):
        super().__init__(min_size, max_size, keep_ratio=True)
