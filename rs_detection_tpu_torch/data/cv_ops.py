"""numpy twins of the OpenCV calls of the JAX YOLO data path
(``rs_detection_tpu/data/yolo.py`` and ``PhotoMetricDistortion``), so
that the port needs no cv2 and one seed gives the same pixels: uint8
HWC, three channels, equal to OpenCV 5.0's output on the same input.

* ``rgb2hsv``: ``cvtColor(COLOR_RGB2HSV)``, OpenCV's integer form (12-bit
  fixed-point tables, H in [0, 180)), exact.
* ``hsv2rgb``: ``cvtColor(COLOR_HSV2RGB)``: f32 sector arithmetic with
  fused ``1 - s * h``, truncated to uint8 as OpenCV's vector code does
  (its scalar form, on the last pixels of a row, rounds: one grey level
  apart at most).
* ``resize_linear``: ``resize(INTER_LINEAR)``: 11-bit horizontal
  weights, the border column clamped, the rows' weights unclamped, the
  vertical pass as OpenCV's vector code rounds it.
* ``warp_affine`` / ``warp_perspective`` (``INTER_LINEAR``, a constant
  border): the inverse map in f64, source coordinates in f32 (fused as
  OpenCV's vector code fuses them; its scalar form on the last pixels of
  a row fuses otherwise, one grey level apart at most), fused f32
  lerps, rounded to nearest.
* ``rotation_matrix_2d``: ``getRotationMatrix2D``.

The tests hold ``rgb2hsv``, ``resize_linear``, ``copy_make_border`` and
``rotation_matrix_2d`` against cv2 bit for bit, ``hsv2rgb`` and the
warps within one grey level."""

from __future__ import annotations

import math

import numpy as np

F32, F64 = np.float32, np.float64
HSV_SHIFT = 12


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once (the product is exact in f64)."""
    return (np.asarray(a, F64) * np.asarray(b, F64)
            + np.asarray(c, F64)).astype(F32)


def rgb2hsv(img):
    """uint8 RGB -> uint8 HSV, H in [0, 180)."""
    i = np.arange(1, 256, dtype=F64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << HSV_SHIFT) / i).astype(np.int64)
    hdiv[1:] = np.rint((180 << HSV_SHIFT) / (6.0 * i)).astype(np.int64)
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


# which of (v, v(1-s), v(1-sh), v(1-s(1-h))) is (b, g, r) in each sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv2rgb(img):
    """uint8 HSV (H in [0, 180)) -> uint8 RGB, truncated."""
    h = img[..., 0].astype(F32) * F32(6.0 / 180)
    s = img[..., 1].astype(F32) * F32(1 / 255.0)
    v = img[..., 2].astype(F32) * F32(1 / 255.0)
    sector = np.floor(h)
    h = h - sector
    one = F32(1)
    tab = np.stack([v, v * (one - s), v * _fma(-s, h, one),
                    v * _fma(-s, one - h, one)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64) % 6], -1)
    rgb = np.trunc(bgr[..., ::-1] * F32(255))
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _resize_axis(n_in: int, n_out: int, clamp: bool):
    """Source indices (two) and 11-bit weights of one axis."""
    fx = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(F32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(F32)
    if clamp:
        fx = np.where((sx < 0) | (sx >= n_in - 1), F32(0), fx)
        sx = np.clip(sx, 0, n_in - 1)
    w1 = np.rint(fx * F32(2048)).astype(np.int64)
    w0 = np.rint((F32(1) - fx) * F32(2048)).astype(np.int64)
    return (np.clip(sx, 0, n_in - 1), np.clip(sx + 1, 0, n_in - 1), w0, w1)


def resize_linear(img, size):
    """``cv2.resize(img, size)`` (``size`` = (w, h), ``INTER_LINEAR``); at
    the image's own size a copy, as OpenCV's."""
    w, h = int(size[0]), int(size[1])
    if (h, w) == img.shape[:2]:
        return img.copy()
    x0, x1, a0, a1 = _resize_axis(img.shape[1], w, clamp=True)
    y0, y1, b0, b1 = _resize_axis(img.shape[0], h, clamp=False)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[:, None] + src[:, x1] * a1[:, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    out = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def copy_make_border(img, top, bottom, left, right, value):
    """``cv2.copyMakeBorder(..., BORDER_CONSTANT, value=value)``."""
    out = np.empty((img.shape[0] + top + bottom, img.shape[1] + left + right,
                    img.shape[2]), img.dtype)
    out[...] = np.asarray(value, img.dtype)
    out[top:top + img.shape[0], left:left + img.shape[1]] = img
    return out


def rotation_matrix_2d(center, angle, scale):
    """``cv2.getRotationMatrix2D(center, angle, scale)`` (degrees)."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _row_form(m, w, h):
    """f32 ``m[0] x + m[1] y + m[2]`` over the (h, w) grid, fused as
    OpenCV's vector code fuses it."""
    m0, m1, m2 = (F32(v) for v in m)
    x = np.arange(w, dtype=F32)[None, :]
    yb = np.arange(h, dtype=F32)[:, None] * m1
    return _fma(m0, x, yb + m2)


def _bilinear(img, sx, sy, border):
    """Bilinear samples of ``img`` at f32 (sx, sy), ``border`` outside,
    each lerp fused, rounded to nearest uint8."""
    ix, iy = np.floor(sx), np.floor(sy)
    a, b = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.astype(np.int64), iy.astype(np.int64)
    h, w = img.shape[:2]
    src = img.astype(F32)

    def at(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        return np.where(ok[..., None], v, F32(border))

    p00, p01 = at(iy, ix), at(iy, ix + 1)
    p10, p11 = at(iy + 1, ix), at(iy + 1, ix + 1)
    top = _fma(a, p01 - p00, p00)
    bottom = _fma(a, p11 - p10, p10)
    out = _fma(b, bottom - top, top)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def warp_affine(img, m, dsize, border=114):
    """``cv2.warpAffine(img, m, dsize, borderValue=(border,) * 3)``."""
    m = np.asarray(m, F64).reshape(2, 3)
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    inv = [a11, a12, -a11 * m[0, 2] - a12 * m[1, 2],
           a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]
    w, h = int(dsize[0]), int(dsize[1])
    return _bilinear(img, _row_form(inv[:3], w, h),
                     _row_form(inv[3:], w, h), border)


def warp_perspective(img, m, dsize, border=114):
    """``cv2.warpPerspective(img, m, dsize, borderValue=(border,) * 3)``."""
    inv = np.linalg.inv(np.asarray(m, F64).reshape(3, 3)).reshape(-1)
    w, h = int(dsize[0]), int(dsize[1])
    wt = _row_form(inv[6:], w, h)
    return _bilinear(img, _row_form(inv[:3], w, h) / wt,
                     _row_form(inv[3:6], w, h) / wt, border)
