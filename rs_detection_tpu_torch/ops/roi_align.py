"""Level-routed rotated RoIAlign over an FPN pyramid, with its backward.

Counterpart of ``rs_detection_tpu/ops/roi_align.py:roi_align_rotated_pyramid``
(the exact XLA gather path) and of the TPU kernels behind
``ops/pallas_roi_align.py:roi_align_rotated_pyramid_pallas`` (the forward
``_pool_kernel`` and the backward ``_scatter_kernel``). On CUDA tensors
``roi_align_rotated_pyramid`` is an autograd function whose forward
launches K1 and whose backward launches K3; on CPU tensors it runs
``roi_align_rotated_pyramid_reference`` and autograd differentiates
that. K1 runs the row design of ``csrc/roi_align_rotated_fwd.cu`` (a
warp per row of bins, the row's corners worked out once into a table,
merged where a bin spans 3 x 3 pixels; from ``K1_SORT_MIN`` rois the
rois taken bucket by bucket, ``k1_buckets``) where ``k1_plan`` picks it,
16-byte channel vectors at S = 1 or 2, and its first design
(``csrc/roi_align_rotated.cu``, a block per roi, a warp per bin)
otherwise; ``roi_align_rotated_pyramid_first_design`` times the first
design on any shape. K3 is the destination-ordered gather of
``csrc/roi_align_rotated_bwd.cu`` (records, a stable sort by
destination, one warp per pixel; no atomics, the same bits on every
run; its plain version is
``roi_align_rotated_pyramid_bwd_sorted_reference``); its first, atomic
design stays in ``csrc/roi_align_rotated.cu`` as the reference it is
timed against (``roi_align_rotated_pyramid_bwd_first_design``).
Neither path gives the rois a gradient: they reach the op detached
(proposals come from detached RPN outputs, ground truths carry none), as
in the JAX package.

The horizontal ``roi_align`` (counterpart of ``rs_detection_tpu/ops/
roi_align.py:roi_align``, plain XLA gathers there, not a TPU kernel) is
plain PyTorch on every device, taken ``_CHUNK`` rois at a time; autograd
differentiates it.

Layouts as in the JAX package: features per level NHWC
``[N, H_l, W_l, C]``; rois ``[R, 6]`` = (batch_idx, cx, cy, w, h, theta)
with w/h already inflated by the caller; output ``[R, P, P, C]``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ._build import kernel_library
from .dw_conv import H100_SMEM

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# rois per gather in the plain version: bounds its [r, G, G, C] corner
# tensors (about 100 MB each at C=256 in bf16)
_CHUNK = 1024
# records per add in the destination-ordered plain backward
_RECORD_CHUNK = 1 << 16


def map_roi_levels(w, h, num_levels: int, finest_scale: float = 56.0):
    """Level of each roi by sqrt-area (reference ``map_roi_levels``)."""
    scale = torch.sqrt(torch.clamp(w * h, min=1e-6))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).long()


def _corners(rois, h: int, w: int, stride: float, p: int, s: int):
    """The bilinear corners of every sample of ``rois`` on one level of
    h x w pixels, by the arithmetic of ``_pool_level``: (live [r, G, G],
    pixel index y * w + x within the image [r, G, G, 4], weight [r, G,
    G, 4]), G = p * s samples along y (dim 1) and x (dim 2), corners
    (y_lo, x_lo), (y_lo, x_hi), (y_hi, x_lo), (y_hi, x_hi)."""
    dev = rois.device
    inv = 1.0 / torch.tensor(stride, dtype=torch.float32, device=dev)
    cx = rois[:, 1] * inv - 0.5
    cy = rois[:, 2] * inv - 0.5
    rw = torch.clamp(rois[:, 3] * inv, min=1.0)
    rh = torch.clamp(rois[:, 4] * inv, min=1.0)
    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
            ).reshape(-1)
    xx = (grid[None, :] / p - 0.5) * rw[:, None]         # [r, G]
    yy = (grid[None, :] / p - 0.5) * rh[:, None]
    ct = torch.cos(rois[:, 5])[:, None, None]
    st = torch.sin(rois[:, 5])[:, None, None]
    xg = xx[:, None, :]
    yg = yy[:, :, None]
    x = xg * ct + yg * st + cx[:, None, None]            # [r, G, G]
    y = yg * ct - xg * st + cy[:, None, None]

    oob = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y = torch.clamp(y, min=0.0)
    x = torch.clamp(x, min=0.0)
    y_low = y.long()
    x_low = x.long()
    yc = y_low >= h - 1
    xc = x_low >= w - 1
    y_low = torch.where(yc, h - 1, y_low)
    x_low = torch.where(xc, w - 1, x_low)
    y_high = torch.where(yc, h - 1, y_low + 1)
    x_high = torch.where(xc, w - 1, x_low + 1)
    y = torch.where(yc, y_low.float(), y)
    x = torch.where(xc, x_low.float(), x)
    ly = y - y_low.float()
    lx = x - x_low.float()
    hy = 1.0 - ly
    hx = 1.0 - lx
    idx = torch.stack([y_low * w + x_low, y_low * w + x_high,
                       y_high * w + x_low, y_high * w + x_high], -1)
    wt = torch.stack([hy * hx, hy * lx, ly * hx, ly * lx], -1)
    return ~oob, idx, wt


def _pool_level(feat, rois, stride: float, p: int, s: int):
    """Exact rotated RoIAlign of ``rois`` on one level, f32 sums."""
    n, h, w, c = feat.shape
    r = rois.shape[0]
    dev = rois.device
    b = torch.clamp(rois[:, 0].long(), 0, n - 1)
    inv = 1.0 / torch.tensor(stride, dtype=torch.float32, device=dev)
    cx = rois[:, 1] * inv - 0.5
    cy = rois[:, 2] * inv - 0.5
    rw = torch.clamp(rois[:, 3] * inv, min=1.0)
    rh = torch.clamp(rois[:, 4] * inv, min=1.0)
    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
            ).reshape(-1)
    xx = (grid[None, :] / p - 0.5) * rw[:, None]         # [r, G]
    yy = (grid[None, :] / p - 0.5) * rh[:, None]
    ct = torch.cos(rois[:, 5])[:, None, None]
    st = torch.sin(rois[:, 5])[:, None, None]
    xg = xx[:, None, :]
    yg = yy[:, :, None]
    x = xg * ct + yg * st + cx[:, None, None]            # [r, G, G]
    y = yg * ct - xg * st + cy[:, None, None]

    oob = (y < -1.0) | (y > h) | (x < -1.0) | (x > w)
    y = torch.clamp(y, min=0.0)
    x = torch.clamp(x, min=0.0)
    y_low = y.long()
    x_low = x.long()
    yc = y_low >= h - 1
    xc = x_low >= w - 1
    y_low = torch.where(yc, h - 1, y_low)
    x_low = torch.where(xc, w - 1, x_low)
    y_high = torch.where(yc, h - 1, y_low + 1)
    x_high = torch.where(xc, w - 1, x_low + 1)
    y = torch.where(yc, y_low.float(), y)
    x = torch.where(xc, x_low.float(), x)
    ly = (y - y_low.float())[..., None]
    lx = (x - x_low.float())[..., None]
    hy = 1.0 - ly
    hx = 1.0 - lx

    flat = feat.reshape(n * h * w, c)
    row = (b * h)[:, None, None]

    def g(yi, xi):
        return flat[(row + yi) * w + xi].float()        # [r, G, G, C]

    out = (hy * hx * g(y_low, x_low) + hy * lx * g(y_low, x_high)
           + ly * hx * g(y_high, x_low) + ly * lx * g(y_high, x_high))
    out = torch.where(oob[..., None], 0.0, out)
    return out.reshape(r, p, s, p, s, c).mean(dim=(2, 4))


def roi_align_rotated_pyramid_reference(feats: Sequence[torch.Tensor], rois,
                                        output_size: int = 7,
                                        strides=(4, 8, 16, 32),
                                        sampling_ratio: int = 2,
                                        finest_scale: float = 56.0):
    """Plain PyTorch version: each roi sampled at its own level."""
    p, s = output_size, sampling_ratio
    feats = list(feats)[:len(strides)]
    c = feats[0].shape[-1]
    rois = rois.float()
    lvl = map_roi_levels(rois[:, 3], rois[:, 4], len(strides), finest_scale)
    out = torch.zeros(rois.shape[0], p, p, c, dtype=feats[0].dtype,
                      device=rois.device)
    for i, (feat, stride) in enumerate(zip(feats, strides)):
        idx = torch.nonzero(lvl == i).flatten()
        for j in range(0, idx.numel(), _CHUNK):
            sel = idx[j:j + _CHUNK]
            out[sel] = _pool_level(feat, rois[sel], float(stride), p,
                                   s).to(out.dtype)
    return out


def _axis_corners(t, size: int):
    """The bilinear corners of sample coordinates ``t`` along one axis of
    ``size`` pixels, with the border rules of ``_pool_level``: (low, high,
    weight of low, weight of high, out of range)."""
    oob = (t < -1.0) | (t > size)
    t = torch.clamp(t, min=0.0)
    low = t.long()
    edge = low >= size - 1
    low = torch.where(edge, size - 1, low)
    high = torch.where(edge, size - 1, low + 1)
    t = torch.where(edge, low.float(), t)
    lt = t - low.float()
    return low, high, 1.0 - lt, lt, oob


def _roi_align_chunk(feat, rois, scale: float, p: int, s: int):
    n, h, w, c = feat.shape
    r = rois.shape[0]
    dev = rois.device
    b = torch.clamp(rois[:, 0].long(), 0, n - 1)
    x1 = rois[:, 1] * scale
    y1 = rois[:, 2] * scale
    rw = torch.clamp(rois[:, 3] * scale - x1, min=1.0)
    rh = torch.clamp(rois[:, 4] * scale - y1, min=1.0)
    grid = (torch.arange(p, dtype=torch.float32, device=dev)[:, None]
            + (torch.arange(s, dtype=torch.float32, device=dev) + 0.5) / s
            ).reshape(-1) / p
    # x depends on the sample's column only, y on its row only
    x_lo, x_hi, hx, lx, oob_x = _axis_corners(
        x1[:, None] + grid[None, :] * rw[:, None], w)      # [r, G]
    y_lo, y_hi, hy, ly, oob_y = _axis_corners(
        y1[:, None] + grid[None, :] * rh[:, None], h)
    flat = feat.reshape(n * h * w, c)
    row = (b * h)[:, None, None]

    def g(yi, xi):                                        # [r, G, G, C]
        return flat[(row + yi[:, :, None]) * w + xi[:, None, :]].float()

    def wt(a, b_):
        return (a[:, :, None] * b_[:, None, :])[..., None]

    out = (wt(hy, hx) * g(y_lo, x_lo) + wt(hy, lx) * g(y_lo, x_hi)
           + wt(ly, hx) * g(y_hi, x_lo) + wt(ly, lx) * g(y_hi, x_hi))
    oob = oob_y[:, :, None] | oob_x[:, None, :]
    out = torch.where(oob[..., None], 0.0, out)
    return out.reshape(r, p, s, p, s, c).mean(dim=(2, 4))


def roi_align(features, rois, output_size: int = 7,
              spatial_scale: float = 1.0, sampling_ratio: int = 2):
    """Horizontal RoIAlign (torchvision style, no half-pixel offset) of
    ``rois`` [R, 5] = (batch_idx, x1, y1, x2, y2) on one NHWC level:
    ``sampling_ratio``^2 samples per bin from the roi's corner over
    ``max(x2 * s - x1 * s, 1)`` x ``max(y2 * s - y1 * s, 1)``, bilinear
    with the border semantics of the rotated version. Returns [R, P, P,
    C] in the features' dtype (f32 sums), ``_CHUNK`` rois at a time."""
    if sampling_ratio <= 0:
        raise ValueError("roi_align: sampling_ratio must be positive")
    rois = rois.float()
    parts = [_roi_align_chunk(features, rois[i:i + _CHUNK],
                              float(spatial_scale), output_size,
                              sampling_ratio)
             for i in range(0, rois.shape[0], _CHUNK)]
    if not parts:
        return features.new_zeros(0, output_size, output_size,
                                  features.shape[-1])
    return torch.cat(parts).to(features.dtype)


class ROIAlign:
    """Module-style wrapper of ``roi_align`` (the JAX class)."""

    def __init__(self, output_size, spatial_scale, sampling_ratio=2):
        self.output_size = (output_size if isinstance(output_size, int)
                            else output_size[0])
        self.spatial_scale = spatial_scale
        self.sampling_ratio = max(int(sampling_ratio), 1)

    def __call__(self, features, rois):
        return roi_align(features, rois, self.output_size,
                         self.spatial_scale, self.sampling_ratio)


def _merged_bins(o, wt, w: int):
    """K1's corner merging on the bins of one level: o / wt [..., S*S, 4]
    (pixel y * w + x, -1 for a dead sample; weight) -> (whether the bin's
    live corners fit a 3 x 3 window, the window's 9 entries: pixel, -1
    where the added weight is 0, and weight). A sample's weights are
    added corner by corner into the window, then the samples' sums
    pairwise, ((s0 + s1) + (s2 + s3)), as the kernel's shuffles add
    them."""
    live = o[..., 0] >= 0
    y, x = torch.div(o, w, rounding_mode="floor"), o % w
    big = torch.iinfo(torch.int64).max // 4
    y0 = torch.where(live, y[..., 0], big).min(-1).values
    x0 = torch.where(live, x[..., 0], big).min(-1).values
    y1 = torch.where(live, y[..., 3], -big).max(-1).values
    x1 = torch.where(live, x[..., 3], -big).max(-1).values
    fits = live.any(-1) & (y1 - y0 < 3) & (x1 - x0 < 3)
    slot = (y - y0[..., None, None]) * 3 + x - x0[..., None, None]
    part = torch.zeros(*o.shape[:-1], 9, device=o.device)   # per sample
    for k in range(4):
        hit = live[..., None] & (slot[..., k, None] == torch.arange(
            9, device=o.device))
        part = part + torch.where(hit, wt[..., k, None], 0.0)
    while part.shape[-2] > 1:           # pairwise, as the shuffles add
        part = part[..., 0::2, :] + part[..., 1::2, :]
    w9 = part[..., 0, :]
    e = torch.arange(9, device=o.device)
    pix = (y0[..., None] + e // 3) * w + x0[..., None] + e % 3
    return fits, torch.where(w9 != 0, pix, -1), w9


def k1_row_tables(feats: Sequence[torch.Tensor], rois, output_size: int = 7,
                  strides=(4, 8, 16, 32), sampling_ratio: int = 2,
                  finest_scale: float = 56.0):
    """The corner tables of K1's row design, one per (roi, row of bins):
    (level [R]; pixel y * w + x within the roi's image on its level
    [R, P, P, 4 * S * S], -1 where nothing is loaded; weight, f32; the
    entries a bin adds [R, P, P]), bins along dim 2. A bin holds its
    samples (iy, ix) corner by corner in the order K1 adds them (a dead
    sample: pixel -1, weight 0), worked out by ``_corners``, the plain
    forward's arithmetic; at S = 2 a bin whose live corners fit a 3 x 3
    pixel window holds that window instead (``_merged_bins``): 9
    entries, then -1."""
    p, s = output_size, sampling_ratio
    feats = list(feats)[:len(strides)]
    rois = rois.float()
    r = rois.shape[0]
    ss = s * s
    lvl = map_roi_levels(rois[:, 3], rois[:, 4], len(strides), finest_scale)
    pix = torch.full((r, p, p, 4 * ss), -1, dtype=torch.int64,
                     device=rois.device)
    wts = torch.zeros(r, p, p, 4 * ss, device=rois.device)
    count = torch.full((r, p, p), 4 * ss, dtype=torch.int64,
                       device=rois.device)
    for i, (feat, stride) in enumerate(zip(feats, strides)):
        idx = torch.nonzero(lvl == i).flatten()
        if idx.numel() == 0:
            continue
        live, o, wt = _corners(rois[idx], feat.shape[1], feat.shape[2],
                               float(stride), p, s)
        o = torch.where(live[..., None], o, -1)
        wt = torch.where(live[..., None], wt, 0.0)
        # [k, Gy, Gx, 4] -> [k, py, iy, px, ix, 4] -> [k, py, px, iy, ix, 4]
        o = o.reshape(-1, p, s, p, s, 4).permute(0, 1, 3, 2, 4, 5) \
            .reshape(-1, p, p, ss, 4)
        wt = wt.reshape(-1, p, s, p, s, 4).permute(0, 1, 3, 2, 4, 5) \
            .reshape(-1, p, p, ss, 4)
        merge = 4 * ss > 9
        if merge:
            fits, mpix, mw = _merged_bins(o, wt, feat.shape[2])
        o, wt = o.reshape(-1, p, p, 4 * ss), wt.reshape(-1, p, p, 4 * ss)
        if merge:
            tail = 4 * ss - 9
            mpix = torch.cat([mpix, torch.full_like(o[..., :tail], -1)], -1)
            mw = torch.cat([mw, torch.zeros_like(wt[..., :tail])], -1)
            o = torch.where(fits[..., None], mpix, o)
            wt = torch.where(fits[..., None], mw, wt)
            count[idx] = torch.where(fits, 9, 4 * ss)
        pix[idx], wts[idx] = o, wt
    return lvl, pix, wts, count


def roi_align_rotated_pyramid_rows_reference(
        feats: Sequence[torch.Tensor], rois, output_size: int = 7,
        strides=(4, 8, 16, 32), sampling_ratio: int = 2,
        finest_scale: float = 56.0):
    """Plain version of K1's row design: ``k1_row_tables``, then per bin
    its entries added one after the other in f32 (an entry with pixel -1
    adds nothing), times 1 / S^2, one rounding to the features' dtype."""
    p, s = output_size, sampling_ratio
    feats = list(feats)[:len(strides)]
    c = feats[0].shape[-1]
    rois = rois.float()
    lvl, pix, wts, _ = k1_row_tables(feats, rois, p, strides, s,
                                     finest_scale)
    b = rois[:, 0].long()
    out = torch.zeros(rois.shape[0], p, p, c, device=rois.device)
    for i, feat in enumerate(feats):
        sel = lvl == i
        if not sel.any():
            continue
        n, h, w = feat.shape[:3]
        flat = feat.reshape(-1, c).float()
        base = (torch.clamp(b[sel], 0, n - 1) * h * w)[:, None, None]
        acc = torch.zeros(int(sel.sum()), p, p, c, device=rois.device)
        for j in range(pix.shape[-1]):
            o = pix[sel][..., j]
            val = flat[torch.clamp(base + o, min=0)]
            acc = acc + wts[sel][..., j, None] * torch.where(
                (o >= 0)[..., None], val, 0.0)
        out[sel] = acc
    return (out * (1.0 / (s * s))).to(feats[0].dtype)


def _requires_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_pyramid(feats, strides):
    """Validated levels of a kernel call: (feats, N, C, [h0, w0, ...],
    [s0, ...]), the last two padded to 4 levels."""
    feats = list(feats)[:len(strides)]
    if not 1 <= len(feats) <= 4 or len(feats) != len(strides):
        raise ValueError(f"roi_align kernel takes 1-4 levels with one stride "
                         f"each, got {len(feats)} levels, strides {strides}")
    f0 = feats[0]
    if f0.dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_align kernel takes float32 or bfloat16 "
                        f"features, not {f0.dtype}")
    n, c = f0.shape[0], f0.shape[-1]
    for i, f in enumerate(feats):
        if not f.is_cuda or f.device != f0.device:
            raise ValueError(f"roi_align: level {i} is on {f.device}")
        if f.dtype != f0.dtype or f.dim() != 4 or f.shape[0] != n \
                or f.shape[-1] != c:
            raise ValueError(f"roi_align: level {i} is {f.dtype} "
                             f"{tuple(f.shape)}, level 0 {f0.dtype} "
                             f"{tuple(f0.shape)}")
        if not f.is_contiguous():
            raise ValueError(f"roi_align: level {i} must be contiguous NHWC")
    pad = 4 - len(feats)
    hs = [f.shape[1] for f in feats] + [1] * pad
    ws = [f.shape[2] for f in feats] + [1] * pad
    hw = [v for pair in zip(hs, ws) for v in pair]
    ss = [float(x) for x in strides] + [1.0] * pad
    return feats, n, c, hw, ss


def _check_rois(rois, device):
    if rois.device != device or rois.dtype != torch.float32 \
            or rois.dim() != 2 or rois.shape[1] != 6 \
            or not rois.is_contiguous():
        raise ValueError(f"roi_align: rois must be contiguous float32 "
                         f"[R, 6] on {device}, got {rois.dtype} "
                         f"{tuple(rois.shape)} on {rois.device}")


# the row design of K1: warps per block, samples per bin side it is built for
K1_ROW_WARPS = 8
K1_ROW_SAMPLES = (1, 2)
# shared memory a block may take without opting in
K1_SMEM_LIMIT = 48 * 1024
# rois from which the row design takes them bucket by bucket (level, image,
# cell of K1_CELL x K1_CELL pixels of the level; ``k1_buckets``): warps that
# run together then read neighbouring pixels. One block orders them, with a
# counter per bucket, 32 warp totals and each roi's bucket in shared memory
# (4 bytes each).
K1_SORT_MIN = 8192
K1_CELL = 16


def k1_bucket_count(n: int, sizes) -> int:
    """Buckets of K1's order over ``n`` images with levels of ``sizes``
    [(h, w), ...] pixels."""
    return sum(n * -(-h // K1_CELL) * -(-w // K1_CELL) for h, w in sizes)


def k1_buckets(feats: Sequence[torch.Tensor], rois, strides=(4, 8, 16, 32),
               finest_scale: float = 56.0):
    """Plain version of the bucket of each roi in K1's order: level (by
    ``map_roi_levels``), clamped batch index, then the cell of K1_CELL x
    K1_CELL pixels of the level that holds the centre (clamped to the
    level), cells row by row; returns (bucket [R], bucket count)."""
    feats = list(feats)[:len(strides)]
    rois = rois.float()
    n = feats[0].shape[0]
    lvl = map_roi_levels(rois[:, 3], rois[:, 4], len(strides), finest_scale)
    b = torch.clamp(rois[:, 0].long(), 0, n - 1)
    out = torch.zeros(rois.shape[0], dtype=torch.int64, device=rois.device)
    base = 0
    for i, (f, stride) in enumerate(zip(feats, strides)):
        cy, cx = -(-f.shape[1] // K1_CELL), -(-f.shape[2] // K1_CELL)
        inv = 1.0 / torch.tensor(float(stride) * K1_CELL,
                                 device=rois.device)
        x = torch.clamp(torch.floor(rois[:, 1] * inv).long(), 0, cx - 1)
        y = torch.clamp(torch.floor(rois[:, 2] * inv).long(), 0, cy - 1)
        out = torch.where(lvl == i, base + (b * cy + y) * cx + x, out)
        base += n * cy * cx
    return out, base


def k1_plan(c: int, dtype, output_size: int = 7, sampling_ratio: int = 2,
            rois: int = 1, aligned: bool = True, buckets: int = 0):
    """How K1 runs ``rois`` rois at width ``c`` in ``dtype``, mirrored
    from the launchers in ``csrc/``: ``"rows"`` (one 16-byte vector of
    channels per lane, C a multiple of it and the levels 16-byte aligned,
    S in ``K1_ROW_SAMPLES``): ``vec``, ``warps`` per block, the corner
    table's shared memory ``smem``, ``blocks`` (one warp per row of bins)
    and ``sort`` (the rois taken bucket by bucket, from ``K1_SORT_MIN``
    rois, where the order kernel's shared memory for ``buckets`` and the
    rois fits the H100's); ``"first"`` otherwise: ``vec`` (1 or 16 bytes) and one block
    per roi. Raises for what no design takes."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_align kernel takes float32 or bfloat16 "
                        f"features, not {dtype}")
    p, s = output_size, sampling_ratio
    if c < 1 or p < 1 or s < 1 or rois < 0:
        raise ValueError(f"roi_align kernel: C={c}, output_size={p}, "
                         f"sampling_ratio={s}, {rois} rois")
    vec = 16 // (4 if dtype == torch.float32 else 2)
    if c % vec or not aligned:
        vec = 1
    smem = K1_ROW_WARPS * p * (s * s * 4 * 8 + 4)
    if vec > 1 and s in K1_ROW_SAMPLES and smem <= K1_SMEM_LIMIT \
            and rois * p < 2 ** 31:
        return dict(design="rows", vec=vec, warps=K1_ROW_WARPS, smem=smem,
                    blocks=-(-rois * p // K1_ROW_WARPS),
                    sort=rois >= K1_SORT_MIN
                    and (buckets + 32 + rois) * 4 <= H100_SMEM)
    return dict(design="first", vec=vec, blocks=rois)


def _k1_order(lib, feats, n, hw, ss, rois, finest_scale, stream):
    """The order in which K1's row design takes the rois (int64 roi
    indices, bucket by bucket; one kernel)."""
    order = torch.empty(rois.shape[0], dtype=torch.int64,
                        device=rois.device)
    err = lib.rs_roi_align_rows_order(len(feats), n, *hw, *ss,
                                      rois.data_ptr(), rois.shape[0],
                                      float(finest_scale), order.data_ptr(),
                                      stream)
    if err != 0:
        raise RuntimeError(f"roi_align order kernel launch failed: CUDA "
                           f"error {err}")
    return order


def _k1_launch(feats, rois, output_size, strides, sampling_ratio,
               finest_scale, first: bool):
    """Check the operands and launch K1's design (the plan's, or the
    first with ``first``); returns the output."""
    feats, n, c, hw, ss = _check_pyramid(feats, strides)
    f0 = feats[0]
    _check_rois(rois, f0.device)
    p, s = output_size, sampling_ratio
    r = rois.shape[0]
    plan = k1_plan(c, f0.dtype, p, s, r,
                   not any(f.data_ptr() % 16 for f in feats),
                   k1_bucket_count(n, [f.shape[1:3] for f in feats]))
    out = torch.empty(r, p, p, c, dtype=f0.dtype, device=f0.device)
    ptrs = [f.data_ptr() for f in feats] + [None] * (4 - len(feats))
    lib = kernel_library()
    rows = not first and plan["design"] == "rows"
    with torch.cuda.device(f0.device):
        stream = torch.cuda.current_stream().cuda_stream
        order = _k1_order(lib, feats, n, hw, ss, rois, finest_scale, stream) \
            if rows and plan["sort"] else None
        if not first:
            roi_align_rotated_pyramid_cuda.launches += 1
        if rows:
            err = lib.rs_roi_align_rotated_pyramid_fwd_rows(
                *ptrs, len(feats), n, c, *hw, *ss, rois.data_ptr(),
                None if order is None else order.data_ptr(), r, p, s,
                float(finest_scale), out.data_ptr(), _DTYPE_CODE[f0.dtype],
                plan["vec"], stream)
        else:
            err = lib.rs_roi_align_rotated_pyramid_fwd(
                *ptrs, len(feats), n, c, *hw, *ss, rois.data_ptr(), r, p, s,
                float(finest_scale), out.data_ptr(), _DTYPE_CODE[f0.dtype],
                plan["vec"], stream)
    if err != 0:
        raise RuntimeError(f"roi_align kernel launch failed: CUDA error {err}")
    return out


def roi_align_rotated_pyramid_cuda(feats: Sequence[torch.Tensor], rois,
                                   output_size: int = 7,
                                   strides=(4, 8, 16, 32),
                                   sampling_ratio: int = 2,
                                   finest_scale: float = 56.0):
    """Launch K1 on CUDA tensors (f32 or bf16 features), the design
    ``k1_plan`` picks. Raises when grad mode is on and an input requires
    a gradient: autograd does not see this launch, so a result from it
    would be cut off from the graph (``roi_align_rotated_pyramid`` is the
    differentiable entry point)."""
    if _requires_grad(rois, *feats):
        raise RuntimeError("roi_align_rotated_pyramid_cuda: an input requires "
                           "a gradient; call roi_align_rotated_pyramid, whose "
                           "backward is the K3 kernel")
    return _k1_launch(feats, rois, output_size, strides, sampling_ratio,
                      finest_scale, first=False)


roi_align_rotated_pyramid_cuda.launches = 0


def roi_align_rotated_pyramid_first_design(feats: Sequence[torch.Tensor],
                                           rois, output_size: int = 7,
                                           strides=(4, 8, 16, 32),
                                           sampling_ratio: int = 2,
                                           finest_scale: float = 56.0):
    """``roi_align_rotated_pyramid_cuda``'s operands through K1's first
    design (one block per roi, one warp per bin) whatever ``k1_plan``
    picks: for timing the two designs side by side. Not counted."""
    return _k1_launch(feats, rois, output_size, strides, sampling_ratio,
                      finest_scale, first=True)


def k3_vec(c: int, dtype, aligned: bool = True) -> int:
    """Channels per lane of K3 at width ``c`` in ``dtype``: one 16-byte
    vector (8 bf16, 4 f32) when C is a multiple of that and ``grad`` is
    16-byte aligned, else 1."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_align kernel takes float32 or bfloat16, not "
                        f"{dtype}")
    vec = 16 // (4 if dtype == torch.float32 else 2)
    return vec if c % vec == 0 and aligned else 1


def _pixel_count(feats) -> int:
    return sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats)


def roi_align_rotated_pyramid_bwd_cuda(feats: Sequence[torch.Tensor], rois,
                                       grad, output_size: int = 7,
                                       strides=(4, 8, 16, 32),
                                       sampling_ratio: int = 2,
                                       finest_scale: float = 56.0):
    """Launch K3, the adjoint of K1: ``grad`` [R, P, P, C] (contiguous,
    the features' dtype) -> one gradient per level, shaped and typed as
    ``feats`` (whose values are not read). The destination-ordered
    gather: f32 sums in a fixed order, one write per output element."""
    feats, n, c, hw, ss = _check_pyramid(feats, strides)
    if _requires_grad(grad):
        raise RuntimeError("roi_align_rotated_pyramid_bwd_cuda: grad requires "
                           "a gradient; K3 has no backward of its own")
    f0 = feats[0]
    _check_rois(rois, f0.device)
    p, s = output_size, sampling_ratio
    r = rois.shape[0]
    if tuple(grad.shape) != (r, p, p, c) or grad.dtype != f0.dtype \
            or grad.device != f0.device or not grad.is_contiguous():
        raise ValueError(f"roi_align backward: grad must be contiguous "
                         f"{f0.dtype} {(r, p, p, c)} on {f0.device}, got "
                         f"{grad.dtype} {tuple(grad.shape)} on {grad.device}")
    if _pixel_count(feats) >= 2 ** 31 - 1:
        raise ValueError("roi_align backward: the pyramid has 2^31 pixels or "
                         "more, past the gather design's int32 destinations")
    with torch.cuda.device(f0.device):
        roi_align_rotated_pyramid_bwd_cuda.launches += 1
        return _bwd_gather(feats, n, c, hw, ss, rois, grad, p, s,
                           float(finest_scale))


roi_align_rotated_pyramid_bwd_cuda.launches = 0


def roi_align_rotated_pyramid_bwd_first_design(
        feats: Sequence[torch.Tensor], rois, grad, output_size: int = 7,
        strides=(4, 8, 16, 32), sampling_ratio: int = 2,
        finest_scale: float = 56.0):
    """``roi_align_rotated_pyramid_bwd_cuda``'s operands through K3's
    first, atomic design: for timing the two designs side by side. Not
    counted; checks only the pyramid and the rois."""
    feats, n, c, hw, ss = _check_pyramid(feats, strides)
    _check_rois(rois, feats[0].device)
    with torch.cuda.device(feats[0].device):
        return _bwd_atomic(feats, n, c, hw, ss, rois, grad, output_size,
                           sampling_ratio, float(finest_scale))


def _bwd_gather(feats, n, c, hw, ss, rois, grad, p, s, finest_scale):
    """K3's destination-ordered design on checked operands: records, a
    stable sort by destination, each pixel's first record, the sums."""
    f0 = feats[0]
    dev = f0.device
    nrec = rois.shape[0] * p * p * s * s * 4
    keys = torch.empty(nrec, dtype=torch.int32, device=dev)
    wts = torch.empty(nrec, dtype=torch.float32, device=dev)
    outs = [torch.empty(f.shape, dtype=f0.dtype, device=dev) for f in feats]
    pad = [None] * (4 - len(feats))
    lib = kernel_library()
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.rs_roi_align_rotated_pyramid_bwd_records(
        len(feats), n, *hw, *ss, rois.data_ptr(), rois.shape[0], p, s,
        finest_scale, keys.data_ptr(), wts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"roi_align backward records kernel launch "
                           f"failed: CUDA error {err}")
    pixels = _pixel_count(feats)
    dest, perm = torch.sort(keys, stable=True)
    starts = torch.searchsorted(
        dest, torch.arange(pixels + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    err = lib.rs_roi_align_rotated_pyramid_bwd_gather(
        grad.data_ptr(), perm.data_ptr(), wts.data_ptr(), starts.data_ptr(),
        len(feats), n, c, *hw, 4 * s * s, *[t.data_ptr() for t in outs],
        *pad, _DTYPE_CODE[f0.dtype],
        k3_vec(c, f0.dtype, grad.data_ptr() % 16 == 0), stream)
    if err != 0:
        raise RuntimeError(f"roi_align backward gather kernel launch failed: "
                           f"CUDA error {err}")
    return outs


def _bwd_atomic(feats, n, c, hw, ss, rois, grad, p, s, finest_scale):
    """K3's first design on checked operands: f32 atomics into a zeroed
    f32 pyramid, cast once to the features' dtype."""
    f0 = feats[0]
    vec = k3_vec(c, f0.dtype, grad.data_ptr() % 16 == 0)
    scratch = [torch.zeros(f.shape, dtype=torch.float32, device=f0.device)
               for f in feats]
    outs = scratch if f0.dtype == torch.float32 else [
        torch.empty(f.shape, dtype=f0.dtype, device=f0.device) for f in feats]
    pad = [None] * (4 - len(feats))
    lib = kernel_library()
    err = lib.rs_roi_align_rotated_pyramid_bwd(
        grad.data_ptr(), len(feats), n, c, *hw, *ss, rois.data_ptr(),
        rois.shape[0], p, s, finest_scale, *[t.data_ptr() for t in scratch],
        *pad, *[t.data_ptr() for t in outs], *pad, _DTYPE_CODE[f0.dtype], vec,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"roi_align backward kernel launch failed: CUDA "
                           f"error {err}")
    return outs


def roi_align_rotated_pyramid_bwd_reference(feats: Sequence[torch.Tensor],
                                            rois, grad, output_size: int = 7,
                                            strides=(4, 8, 16, 32),
                                            sampling_ratio: int = 2,
                                            finest_scale: float = 56.0):
    """Plain version of K3: autograd of the plain forward, in f32 (one
    rounding to the features' dtype at the end, as K3)."""
    with torch.enable_grad():
        leaves = [f.detach().float().requires_grad_()
                  for f in list(feats)[:len(strides)]]
        out = roi_align_rotated_pyramid_reference(
            leaves, rois, output_size, strides, sampling_ratio, finest_scale)
        grads = torch.autograd.grad(out, leaves, grad.float(),
                                    allow_unused=True)
    return [(torch.zeros_like(f) if d is None else d).to(f.dtype)
            for f, d in zip(feats, grads)]


def _bwd_records(feats, rois, p: int, strides, s: int,
                 finest_scale: float):
    """The records of K3's destination-ordered design, in (roi, bin,
    sample, corner) order: (destination pixel over the whole pyramid,
    int64, the pixel count for a sample outside the border band; weight
    / s^2, f32, 0 when dead; the pixel count)."""
    r = rois.shape[0]
    lvl = map_roi_levels(rois[:, 3], rois[:, 4], len(strides), finest_scale)
    total = _pixel_count(feats)
    keys = torch.full((r, p, p, s, s, 4), total, dtype=torch.int64,
                      device=rois.device)
    wts = torch.zeros(r, p, p, s, s, 4, device=rois.device)
    off = 0
    for i, (feat, stride) in enumerate(zip(feats, strides)):
        n, h, w = feat.shape[:3]
        idx = torch.nonzero(lvl == i).flatten()
        for j in range(0, idx.numel(), _CHUNK):
            sel = idx[j:j + _CHUNK]
            live, pix, wt = _corners(rois[sel], h, w, float(stride), p, s)
            b = torch.clamp(rois[sel, 0].long(), 0, n - 1)
            key = off + (b * h * w)[:, None, None, None] + pix
            key = torch.where(live[..., None], key, total)
            wt = torch.where(live[..., None], wt * (1.0 / (s * s)), 0.0)
            # [k, Gy, Gx, 4] -> [k, py, iy, px, ix, 4] -> [k, py, px, iy, ix, 4]
            keys[sel] = key.reshape(-1, p, s, p, s, 4).permute(0, 1, 3, 2, 4, 5)
            wts[sel] = wt.reshape(-1, p, s, p, s, 4).permute(0, 1, 3, 2, 4, 5)
        off += n * h * w
    return keys.flatten(), wts.flatten(), total


def roi_align_rotated_pyramid_bwd_sorted_reference(
        feats: Sequence[torch.Tensor], rois, grad, output_size: int = 7,
        strides=(4, 8, 16, 32), sampling_ratio: int = 2,
        finest_scale: float = 56.0):
    """Plain version of K3's destination-ordered design: one record per
    bilinear corner of every live sample (destination pixel over the
    pyramid, source row ``r * P * P + bin``, weight / S^2), a stable sort
    by destination, and each pixel's records added to it in f32 in that
    order (``index_add_`` adds in index order on the CPU); one rounding
    to the features' dtype."""
    p, s = output_size, sampling_ratio
    feats = list(feats)[:len(strides)]
    c = feats[0].shape[-1]
    rois = rois.float()
    keys, wts, total = _bwd_records(feats, rois, p, strides, s, finest_scale)
    dest, perm = torch.sort(keys, stable=True)
    live = int((dest < total).sum())
    dest, perm = dest[:live], perm[:live]
    rows, wt = perm // (4 * s * s), wts[perm]
    g = grad.reshape(-1, c).float()
    acc = torch.zeros(total, c, device=rois.device)
    for j in range(0, live, _RECORD_CHUNK):
        sl = slice(j, j + _RECORD_CHUNK)
        acc.index_add_(0, dest[sl], g[rows[sl]] * wt[sl, None])
    outs, off = [], 0
    for f in feats:
        size = f.shape[0] * f.shape[1] * f.shape[2]
        outs.append(acc[off:off + size].reshape(f.shape).to(f.dtype))
        off += size
    return outs


class _RoIAlignRotatedPyramid(torch.autograd.Function):
    """K1 forward, K3 backward; no gradient for the rois."""

    @staticmethod
    def forward(ctx, rois, output_size, strides, sampling_ratio,
                finest_scale, *feats):
        ctx.save_for_backward(rois, *feats)
        ctx.args = (output_size, strides, sampling_ratio, finest_scale)
        return roi_align_rotated_pyramid_cuda(feats, rois, *ctx.args)

    @staticmethod
    def backward(ctx, grad):
        rois, *feats = ctx.saved_tensors
        d_feats = roi_align_rotated_pyramid_bwd_cuda(
            feats, rois, grad.contiguous(), *ctx.args)
        return (None,) * 5 + tuple(d_feats)


def roi_align_rotated_pyramid(feats: Sequence[torch.Tensor], rois,
                              output_size: int = 7, strides=(4, 8, 16, 32),
                              sampling_ratio: int = 2,
                              finest_scale: float = 56.0):
    """Rotated pyramid RoIAlign: K1 (backward K3) for CUDA tensors, the
    plain version for CPU tensors. Returns ``[R, P, P, C]`` in the
    features' dtype."""
    feats = list(feats)[:len(strides)]
    args = (output_size, tuple(strides), sampling_ratio, finest_scale)
    if rois.is_cuda:
        return _RoIAlignRotatedPyramid.apply(rois, *args, *feats)
    if rois.device.type == "cpu":
        return roi_align_rotated_pyramid_reference(feats, rois, *args)
    raise ValueError(f"roi_align: no implementation for device {rois.device}")
