"""Bicubic resize on the tensor's device (counterpart of
``rs_detection_tpu/data/device_resize.py``), in two forms:

* ``resize_cubic(img, out_h, out_w)``: the JAX package's mapping, used
  by ``SceneDataset(rates=...)``: sample ``src = (dst + 0.5) * in / out -
  0.5``, Keys cubic with ``a = -0.75``, border replicate, f32 output
  (JAX keeps these tiles in f32 and does not round them);
* ``resize_cubic_rate(img_u8, rate)``: ``cv2.resize(img, None, fx=rate,
  fy=rate, interpolation=cv2.INTER_CUBIC)`` as ``img_split`` calls it:
  output side ``round(side * rate)`` (half to even, as cv2 rounds), sample
  ``src = (dst + 0.5) / rate - 0.5`` (cast to f32, as cv2 does), cv2's f32
  cubic coefficients, border replicate, f32 sums rounded (half to even)
  and saturated to uint8. It is within 1 LSB of cv2's uint8 result on a
  few pixels in 1e4 and equal at rate 1.0, where there is no resize.

The two agree only where ``side * rate`` is a whole number. Both are two
separable passes of four taps built as index and weight tables on the
host, applied on the device as a gather and an explicit multiply-add per
tap: no matrix product, so cuBLAS never rounds the operands to TF32, and
each multiply and add is one IEEE-rounded operation on the CPU and on
the card alike.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (cv2 uses a=-0.75)."""
    t = np.abs(t)
    return np.where(
        t <= 1.0, (a + 2.0) * t ** 3 - (a + 3.0) * t ** 2 + 1.0,
        np.where(t < 2.0,
                 a * t ** 3 - 5.0 * a * t ** 2 + 8.0 * a * t - 4.0 * a,
                 0.0))


def _clip_taps(i0: np.ndarray, n_in: int) -> np.ndarray:
    return np.stack([np.clip(i0 + k - 1, 0, n_in - 1) for k in range(4)],
                    axis=1).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _tap_tables(n_in: int, n_out: int):
    """(idx [n_out, 4], weights [n_out, 4] f32) of one axis, the JAX
    package's ``in / out`` tables."""
    dst = np.arange(n_out, dtype=np.float64)
    src = (dst + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(src).astype(np.int64)
    frac = src - i0
    dist = np.stack([1.0 + frac, frac, 1.0 - frac, 2.0 - frac], axis=1)
    return _clip_taps(i0, n_in), _cubic_kernel(dist).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _cv2_tap_tables(n_in: int, n_out: int, rate: float):
    """(idx [n_out, 4], weights [n_out, 4] f32) of one axis as cv2's
    ``resize`` builds them for ``fx = rate``: the sample position in f32,
    ``interpolateCubic``'s f32 coefficients (the last one is one minus
    the other three)."""
    dst = np.arange(n_out, dtype=np.float64)
    src = ((dst + 0.5) * (1.0 / rate) - 0.5).astype(np.float32)
    i0 = np.floor(src)
    x = (src - i0).astype(np.float32)
    a = np.float32(-0.75)
    one = np.float32(1.0)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one)
          + np.float32(8) * a) * (x + one) - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    y = one - x
    c2 = ((a + np.float32(2)) * y - (a + np.float32(3))) * y * y + one
    c3 = one - c0 - c1 - c2
    wts = np.stack([c0, c1, c2, c3], axis=1).astype(np.float32)
    return _clip_taps(i0.astype(np.int64), n_in), wts


def _taps(x: torch.Tensor, dim: int, tables) -> torch.Tensor:
    """Four-tap weighted sum of ``x`` [H, W, C] f32 along ``dim``: a
    gather and a multiply-add per tap, in tap order."""
    idx, wts = tables
    idx = torch.from_numpy(idx).to(x.device)
    wts = torch.from_numpy(wts).to(x.device)
    shape = [1, 1, 1]
    shape[dim] = -1
    out = None
    for k in range(4):
        term = x.index_select(dim, idx[:, k]) * wts[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def resize_cubic(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[H, W, C] (uint8 or float) -> [out_h, out_w, C] f32 on ``img``'s
    device, the JAX package's ``resize_cubic`` (rows, then columns)."""
    h, w = int(img.shape[0]), int(img.shape[1])
    x = img.float()
    if (h, w) == (out_h, out_w):
        return x
    x = _taps(x, 0, _tap_tables(h, out_h))
    return _taps(x, 1, _tap_tables(w, out_w))


def resize_cubic_rate(img_u8: torch.Tensor, rate: float) -> torch.Tensor:
    """[H, W, C] uint8 -> [round(H * rate), round(W * rate), C] uint8 on
    ``img_u8``'s device, ``cv2.resize(fx=rate, fy=rate, INTER_CUBIC)``
    within 1 LSB (columns, then rows, as cv2 does); rate 1.0 returns the
    input."""
    if img_u8.dtype != torch.uint8:
        raise TypeError(f"resize_cubic_rate takes uint8, not {img_u8.dtype}")
    if rate == 1.0:
        return img_u8
    h, w = int(img_u8.shape[0]), int(img_u8.shape[1])
    # cv2's saturate_cast<int>: half to even, as Python's round
    oh, ow = int(round(h * rate)), int(round(w * rate))
    x = _taps(img_u8.float(), 1, _cv2_tap_tables(w, ow, float(rate)))
    x = _taps(x, 0, _cv2_tap_tables(h, oh, float(rate)))
    return x.round_().clamp_(0, 255).to(torch.uint8)
