"""Host-side transforms of the test pipeline (counterpart of
``Compose``, ``Resize``, ``RotatedResize``, ``Pad`` and ``Normalize`` in
``rs_detection_tpu/data/transforms.py``): PIL + numpy, before batching.
``Normalize`` emits float32 HWC arrays, so batches are NHWC. The
training augmentations come with the training half of the runner."""

from __future__ import annotations

import random

import numpy as np
from PIL import Image

from ..ops.box_ops import poly_to_rotated_box_np, rotated_box_to_poly_np
from ..utils.registry import TRANSFORMS, build_from_cfg

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
        size = random.choice(self.min_size)
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
