"""Deformable (position-sensitive) RoI pooling, DCN v2's pooling op
(counterpart of ``rs_detection_tpu/ops/dcn_pool.py``).

``deform_roi_pooling``: each output bin averages ``sample_per_part^2``
bilinear samples on the bin's grid, shifted by a learned per-part (x, y)
offset scaled by ``trans_std`` and the roi's size; a sample out of range
is masked and the bin divided by its in-range count (at least 1).
``DCNPooling`` pools without offsets, predicts per-bin offsets and a
sigmoid mask with three FCs (the last zero-initialized), pools again with
the offsets and applies the mask; it is registered in ``BRICKS``.

Plain PyTorch on every device (the JAX function reaches no Pallas call),
a dense gather over the [R, P, P, S, S] sample lattice, ``_CHUNK`` rois
at a time; autograd differentiates it with respect to the features, the
offsets and the FC weights. Features are NHWC ``[N, H, W, C]``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..utils.registry import BRICKS
from .roi_align import _jax_gather

# rois a gather: bounds the [r, P, P, S, S, C] corner tensors (about 100 MB
# each at P = 7, S = 4, C = 256 in f32)
_CHUNK = 512


def _pool_chunk(feats, rois, tx, ty, p: int, s: int, scale: float,
                output_dim: int, gs: int):
    n, height, width, c = feats.shape
    dev = feats.device
    b = rois[:, 0].long()
    # the roi's corners rounded to the integer grid, the far one + 1
    x1 = torch.round(rois[:, 1]) * scale - 0.5
    y1 = torch.round(rois[:, 2]) * scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w = roi_w / p
    bin_h = roi_h / p
    sub_w = bin_w / s
    sub_h = bin_h / s
    pb = torch.arange(p, device=dev)
    ib = torch.arange(s, dtype=torch.float32, device=dev)
    wstart = (x1[:, None, None] + pb[None, None, :] * bin_w[:, None, None]
              + tx * roi_w[:, None, None])                 # [r, P, P]
    hstart = (y1[:, None, None] + pb[None, :, None] * bin_h[:, None, None]
              + ty * roi_h[:, None, None])
    wpos = wstart[..., None, None] + ib[None, None, None, None, :] \
        * sub_w[:, None, None, None, None]                 # [r, P, P, S, S]
    hpos = hstart[..., None, None] + ib[None, None, None, :, None] \
        * sub_h[:, None, None, None, None]
    in_range = ((wpos > -0.5) & (wpos < width - 0.5)
                & (hpos > -0.5) & (hpos < height - 0.5))
    wpos = torch.clamp(wpos, 0.0, width - 1.0)
    hpos = torch.clamp(hpos, 0.0, height - 1.0)
    w0 = torch.floor(wpos).long()
    h0 = torch.floor(hpos).long()
    w1 = torch.clamp(w0 + 1, max=width - 1)
    h1 = torch.clamp(h0 + 1, max=height - 1)
    aw = (wpos - w0)[..., None]
    ah = (hpos - h0)[..., None]
    flat = feats.reshape(n * height * width, c)
    row = b[:, None, None, None, None] * height

    def gather(hh, ww):                                    # [r,P,P,S,S,C]
        return _jax_gather(flat, row + hh, n * height, width, ww)

    val = ((gather(h0, w0) * (1 - aw) + gather(h0, w1) * aw) * (1 - ah)
           + (gather(h1, w0) * (1 - aw) + gather(h1, w1) * aw) * ah)
    val = val * in_range[..., None]
    cnt = torch.clamp(in_range.sum((-1, -2)), min=1)       # [r, P, P]
    pooled = val.sum((-2, -3)) / cnt[..., None]            # [r, P, P, C]
    if gs == 1:
        return pooled[..., :output_dim]
    # bin (ph, pw) reads channel (ctop * gs + gh) * gs + gw
    gh = torch.floor(pb.float() / p * gs).long()
    ctop = torch.arange(output_dim, device=dev)
    chan = (ctop[None, None, :] * gs + gh[:, None, None]) * gs \
        + gh[None, :, None]                                # [P, P, D]
    return torch.take_along_dim(
        pooled, chan[None].expand(*pooled.shape[:3], output_dim), dim=-1)


def deform_roi_pooling(feats, rois, offsets: Optional[torch.Tensor],
                       output_size: int = 7, spatial_scale: float = 1.0,
                       output_dim: Optional[int] = None, group_size: int = 1,
                       part_size: Optional[int] = None,
                       sample_per_part: int = 4, trans_std: float = 0.0):
    """Deformable RoI pooling of ``rois`` [R, 5] = (batch_idx, x1, y1, x2,
    y2) in image coordinates on ``feats`` [N, H, W, C]; ``offsets`` [R,
    2, part, part] (x offsets, then y) or None; ``output_dim`` defaults to
    C / group_size^2. A batch index outside the batch reads the row JAX's
    gather reads, with no gradient, as there. Returns [R, P, P,
    output_dim] in f32 (the features' dtype for f64)."""
    p, s, gs = output_size, sample_per_part, group_size
    part = part_size or p
    if output_dim is None:
        output_dim = feats.shape[-1] // (gs * gs)
    rois = rois.to(torch.promote_types(feats.dtype, torch.float32))
    r = rois.shape[0]
    if offsets is None:
        tx = ty = rois.new_zeros(r, p, p)
    else:
        idx = torch.floor(torch.arange(p, dtype=torch.float32,
                                       device=rois.device) / p * part).long()
        off = offsets.to(rois.dtype)
        tx = off[:, 0][:, idx][:, :, idx] * trans_std      # [R, P, P]
        ty = off[:, 1][:, idx][:, :, idx] * trans_std
    parts = [_pool_chunk(feats, rois[i:i + _CHUNK], tx[i:i + _CHUNK],
                         ty[i:i + _CHUNK], p, s, float(spatial_scale),
                         output_dim, gs)
             for i in range(0, r, _CHUNK)]
    if not parts:
        width = min(output_dim, feats.shape[-1]) if gs == 1 else output_dim
        return rois.new_zeros(0, p, p, width)
    return torch.cat(parts)


@BRICKS.register_module()
class DCNPooling(nn.Module):
    """Deformable RoI pooling with a learned offset and mask branch (the
    JAX module's fields; ``fc1`` / ``fc2`` / ``fc3`` carry the flax
    names, and ``utils/jax_weights.py`` loads a flax tree into them).
    ``fc1`` takes the offset-free pool of ``output_dim`` channels a bin,
    so the features need at least ``output_dim * group_size^2``
    channels."""

    def __init__(self, spatial_scale: float = 1.0 / 16, pooled_size: int = 7,
                 output_dim: int = 256, no_trans: bool = False,
                 group_size: int = 1, part_size: Optional[int] = None,
                 sample_per_part: int = 4, trans_std: float = 0.0,
                 deform_fc_dim: int = 1024):
        super().__init__()
        self.spatial_scale = spatial_scale
        self.pooled_size = pooled_size
        self.output_dim = output_dim
        self.no_trans = no_trans
        self.group_size = group_size
        self.part_size = part_size
        self.sample_per_part = sample_per_part
        self.trans_std = trans_std
        if not no_trans:
            p = pooled_size
            self.fc1 = nn.Linear(p * p * output_dim, deform_fc_dim)
            self.fc2 = nn.Linear(deform_fc_dim, deform_fc_dim)
            self.fc3 = nn.Linear(deform_fc_dim, p * p * 3)
            nn.init.zeros_(self.fc3.weight)
            nn.init.zeros_(self.fc3.bias)

    def _pool(self, feats, rois, offsets):
        return deform_roi_pooling(
            feats, rois, offsets, output_size=self.pooled_size,
            spatial_scale=self.spatial_scale, output_dim=self.output_dim,
            group_size=self.group_size, part_size=self.part_size,
            sample_per_part=self.sample_per_part, trans_std=self.trans_std)

    def forward(self, feats, rois):
        p = self.pooled_size
        base = self._pool(feats, rois, None)               # [R, P, P, D]
        if self.no_trans:
            return base
        x = base.reshape(base.shape[0], -1)
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        om = self.fc3(x).reshape(-1, 3, p, p)
        mask = torch.sigmoid(om[:, 2])                     # [R, P, P]
        return self._pool(feats, rois, om[:, :2]) * mask[..., None]
