"""The flagship Oriented R-CNN (counterpart of ``_flagship`` in the
repository's ``__graft_entry__.py``), with seeded random weights, and
seeded training targets (``make_targets``).

``tiny=False`` is the competition model (configs/orcnn_van3_7_anchor_swa_1.py):
VAN-b3 (dims 64/128/320/512, depths 3/5/27/3, MLP ratios 8/8/4/4),
FPN-256 with 5 outputs, a 7-ratio Oriented RPN (nms_pre = nms_post =
2000, pre_nms_cap 4096) and an OrientedHead with 2x1024 FCs and 10
classes. ``tiny=True`` is the same architecture cut down for CPU tests:
VAN dims 16/32/40/64, depths 1/1/2/1, FPN-32, nms_pre 256, nms_post 64,
pre_nms_cap 512, FC width 64. Both carry the config's training
assigners and samplers.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
from torch import nn

from .models.networks.rcnn import RCNN, OrientedRCNN
from .ops import box_ops as B
from .utils.registry import MODELS, build_from_cfg

# on-device input normalization of the competition config (to_bgr=False)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)
RPN_ANCHORS = dict(scales=[8], ratios=[0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0],
                   strides=[4, 8, 16, 32, 64])
# training assignment and sampling of configs/orcnn_van3_7_anchor_swa_1.py
RPN_ASSIGNER = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3,
                    match_low_quality=True)
RPN_SAMPLER = dict(num=256, pos_fraction=0.5, add_gt_as_proposals=False)
HEAD_ASSIGNER = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5,
                     match_low_quality=False,
                     iou_calculator=dict(type="BboxOverlaps2D_rotated_v1"))
HEAD_SAMPLER = dict(num=512, pos_fraction=0.25, add_gt_as_proposals=True)
NUM_CLASSES = 10


def resolve_device(device=None) -> torch.device:
    """``device``, or the CUDA card when None (an error where there is
    none: the port runs on the card unless the caller asks for the
    CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card by "
                           "default; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def normalize(images_u8):
    """uint8 NHWC tiles -> normalized f32 NHWC, on the tiles' device."""
    m = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=images_u8.device)
    s = torch.tensor(PIXEL_STD, dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() - m) / s


def init_weights(model: nn.Module, g: torch.Generator) -> None:
    """Seeded random init in the spirit of the flax initializers:
    He-normal (fan_out, truncated) convs, N(0, 0.01) RPN convs, Xavier
    shared FCs, N(0, 0.01) / N(0, 0.001) cls / reg FCs, zero biases; a
    head with its own ``init_weights(g)`` (the single-stage heads, R3Det's
    ``frm`` and ``refine_head``) draws its layers after the generic
    pass. BN, LayerNorm and layer scales keep their
    constructor values."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                k = m.kernel_size[0] * m.kernel_size[1]
                std = math.sqrt(2.0 / (k * m.out_channels // m.groups))
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=g)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=g)
                nn.init.zeros_(m.bias)
        rpn = getattr(model, "rpn", None)
        if rpn is not None:
            for conv in (rpn.rpn_conv, rpn.rpn_cls, rpn.rpn_reg):
                conv.weight.normal_(0.0, 0.01, generator=g)
        for part in ("bbox_head", "frm", "refine_head"):
            if hasattr(getattr(model, part, None), "init_weights"):
                getattr(model, part).init_weights(g)
        # every stage's cls / reg FCs, in the order the head holds them
        std = {"fc_cls": 0.01, "fc_reg": 0.001}
        for name, m in model.bbox_head.named_modules():
            if name.split(".")[-1] in std:
                m.weight.normal_(0.0, std[name.split(".")[-1]], generator=g)


def flagship_cfg(tiny: bool = False) -> dict:
    """The flagship's model config section (``type=`` dicts, as a config
    file writes it; a fresh copy the caller may change); ``tiny=True``
    the cut-down form of the CPU tests."""
    if tiny:
        dims, depths, width, fc = [16, 32, 40, 64], [1, 1, 2, 1], 32, 64
        nms_pre, nms_post, cap = 256, 64, 512
    else:
        dims, depths, width, fc = [64, 128, 320, 512], [3, 5, 27, 3], 256, 1024
        nms_pre, nms_post, cap = 2000, 2000, 4096
    return copy.deepcopy(dict(
        type="OrientedRCNN",
        backbone=dict(type="VAN", embed_dims=dims, mlp_ratios=[8, 8, 4, 4],
                      depths=depths),
        neck=dict(type="FPN", in_channels=dims, out_channels=width,
                  num_outs=5),
        rpn=dict(type="OrientedRPNHead", in_channels=width,
                 feat_channels=width, anchor_generator=RPN_ANCHORS,
                 nms_pre=nms_pre, nms_post=nms_post, pre_nms_cap=cap,
                 assigner=RPN_ASSIGNER, sampler=RPN_SAMPLER),
        bbox_head=dict(type="OrientedHead", num_classes=NUM_CLASSES,
                       in_channels=width, fc_out_channels=fc,
                       assigner=HEAD_ASSIGNER, sampler=HEAD_SAMPLER,
                       bbox_roi_extractor=dict(
                           roi_layer=dict(output_size=7, sampling_ratio=2),
                           out_channels=width, extend_factor=(1.4, 1.2),
                           featmap_strides=[4, 8, 16, 32]))))


def build_flagship(tiny: bool = False, device=None,
                   dtype: torch.dtype = torch.float32,
                   generator: Optional[torch.Generator] = None,
                   train: bool = False, fused: bool = False,
                   int8: bool = False) -> OrientedRCNN:
    """Build the flagship on ``device`` (None: the CUDA card, an error
    where there is none), computing in ``dtype``. ``fused=True`` serves
    with the fused VAN blocks (``van_attn`` + ``van_mlp_residual`` per
    block; off by default, ignored in training). ``int8=True`` serves
    in the int8 mode of ``ops/quant.py``: the attention's 1x1 mixes, the
    VAN MLP (its kernel's int8 form), the patch-embed convs of stages
    2-4, the FPN convs and the RPN tower conv run s8 x s8 -> s32 (off by
    default, ignored in training; composes with ``fused``, and changes
    no parameter). For
    inference (``train=False``) it is in eval mode with its parameters
    in ``dtype``; for training it is in train mode with f32 master
    parameters, and the activations are cast to ``dtype``. The weights
    are drawn on the CPU from ``generator`` (seed 0 if None), so one seed
    gives the same model on every device."""
    device = resolve_device(device)
    cfg = flagship_cfg(tiny)
    cfg["backbone"].update(fused=fused, int8=int8)
    cfg["neck"]["int8"] = int8
    cfg["rpn"]["int8"] = int8
    model = build_from_cfg(dict(cfg, compute_dtype=dtype), MODELS)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_weights(model, generator)
    if train:
        return model.to(device=device).train()
    return model.to(device=device, dtype=dtype).eval()


def make_targets(b: int, img: int, max_gt: int,
                 generator: torch.Generator):
    """Seeded training targets for ``b`` square ``img`` tiles, on the
    generator's device: per image the two anchor-matched boxes of
    ``__graft_entry__.py:_dummy_targets`` scaled to ``img`` (so both
    regression losses have positives), then ``max_gt - 2`` boxes with
    centres in the tile, sides 12-400 px (log-uniform, capped at the
    tile) and any angle; 1-based labels of the 10 classes; "hboxes",
    the hbb of each box, for the hbb-RPN networks."""
    dev = generator.device
    n = max_gt - 2

    def u(lo, hi):
        return torch.rand(b, n, generator=generator, device=dev) \
            * (hi - lo) + lo

    hi = min(400.0, float(img))
    side = torch.exp(u(math.log(12.0), math.log(hi)))
    rand = torch.stack([u(0, img), u(0, img), side,
                        torch.exp(u(math.log(12.0), math.log(hi))),
                        u(-math.pi / 2, math.pi / 2)], -1)
    fixed = torch.tensor([[0.40625, 0.40625, 0.5, 0.5, 0.05 / img],
                          [0.65625, 0.53125, 0.6875, 0.34375, -0.08 / img]],
                         device=dev) * img
    rboxes = torch.cat([fixed.expand(b, 2, 5), rand], 1)
    labels = torch.cat([
        torch.tensor([1, 2], device=dev).expand(b, 2),
        torch.randint(1, NUM_CLASSES + 1, (b, n), generator=generator,
                      device=dev)], 1)
    return dict(rboxes=rboxes, hboxes=B.obb2hbb(rboxes), labels=labels,
                gt_mask=torch.ones(b, max_gt, dtype=torch.bool, device=dev),
                img_hw=torch.full((b, 2), float(img), device=dev))
