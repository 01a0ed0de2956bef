"""Anchor targets: assign, sample and encode, dense (counterpart of
``rs_detection_tpu/models/boxes/anchor_target.py``).

Ground truths come padded with a mask, anchors outside the border are
excluded through ``anchor_mask``, and sampling gives weight masks, so
every output is a dense [B, A] or [B, A, D] tensor. The JAX function
takes one image and is vmapped; this one takes the batch on a leading
axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AnchorTargetResult(NamedTuple):
    labels: torch.Tensor            # [B, A] int64 (0 = background)
    label_weights: torch.Tensor     # [B, A] f32
    bbox_targets: torch.Tensor      # [B, A, D]
    bbox_weights: torch.Tensor      # [B, A, D] f32
    num_pos: torch.Tensor           # [B] int64
    num_neg: torch.Tensor           # [B] int64
    assigned_gt_inds: torch.Tensor  # [B, A] (-1 / 0 / k+1)


@torch.no_grad()
def anchor_target_single(anchors, inside_mask, gt_bboxes, gt_mask,
                         gt_labels, assigner, sampler, encode_fn, generator,
                         pos_weight: float = -1.0, gt_bboxes_encode=None,
                         gt_bboxes_ignore=None, gt_ignore_mask=None):
    """anchors [A, D] shared by the batch or [B, A, D] one set an image
    (S2ANet's refined anchors), hbbs or obbs as the assigner reads them;
    inside_mask [A] or [B, A]; gt_bboxes [B, G, D] (assignment boxes),
    gt_mask [B, G], gt_labels [B, G] or None (then positives get label
    1); ``gt_bboxes_encode`` [B, G, D'] the boxes to encode when they
    differ from the assignment boxes (the RPN assigns on the gt hbb and
    encodes the obb). ``encode_fn(anchors, gts) -> deltas`` decides the
    targets' width. ``sampler.sample(assigned, generator)``: a
    ``RandomSampler`` draws from ``generator``, a ``PseudoSampler`` keeps
    every positive and negative and takes None. ``gt_bboxes_ignore`` [B,
    I, D] and ``gt_ignore_mask`` [B, I]: ignore regions, read by an
    assigner with ``ignore_iof_thr > 0``."""
    assigned, _ = assigner.assign(anchors, gt_bboxes, gt_mask,
                                  anchor_mask=inside_mask,
                                  gt_bboxes_ignore=gt_bboxes_ignore,
                                  gt_ignore_mask=gt_ignore_mask)
    pos, neg = sampler.sample(assigned, generator)
    enc = gt_bboxes if gt_bboxes_encode is None else gt_bboxes_encode
    matched = (assigned - 1).clamp(0, enc.shape[1] - 1)
    matched_gts = torch.gather(
        enc, 1, matched[..., None].expand(-1, -1, enc.shape[-1]))
    targets = encode_fn(anchors.expand(*matched.shape, anchors.shape[-1]),
                        matched_gts)
    if gt_labels is None:
        labels = pos.long()
    else:
        labels = torch.where(pos, torch.gather(gt_labels.long(), 1, matched),
                             0)
    pw = 1.0 if pos_weight <= 0 else pos_weight
    label_weights = torch.where(pos, pw, neg.float())
    return AnchorTargetResult(
        labels=labels,
        label_weights=label_weights,
        bbox_targets=torch.where(pos[..., None], targets, 0.0),
        bbox_weights=pos[..., None].float().expand_as(targets),
        num_pos=pos.sum(dim=-1),
        num_neg=neg.sum(dim=-1),
        assigned_gt_inds=assigned)
