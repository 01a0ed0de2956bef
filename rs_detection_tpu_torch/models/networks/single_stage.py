"""Single-stage detectors (counterpart of
``rs_detection_tpu/models/networks/single_stage.py``): backbone -> neck
-> dense head, ``loss`` the training forward and ``predict`` the
inference one: ``S2ANet``, ``RetinaNet``, ``FCOS`` and ``SSD``. ``R3Det``
builds on the class in ``r3det.py``. The YOLO names raise naming their
ROADMAP item."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...utils.registry import (BACKBONES, HEADS, MODELS, NECKS,
                               register_unported)
from ..necks import ssd_neck  # noqa: F401  (registers SSDNeck)
from ..necks.fpn import FPN
from ..roi_heads import fcos_head  # noqa: F401  (registers FCOSHead)
from ..roi_heads import retina_head  # noqa: F401  (registers RetinaHead)
from ..roi_heads import ssd_head  # noqa: F401  (registers SSDHead)
from ..roi_heads.s2anet_head import S2ANetHead
from .compat import adapt_single_stage_head
from .rcnn import _build, _resnet50


def _fpn():
    return FPN(in_channels=(256, 512, 1024, 2048), out_channels=256,
               num_outs=5, add_extra_convs="on_input")


@MODELS.register_module()
class SingleStageDetector(nn.Module):
    """The JAX network's sections: ``backbone``, ``neck`` and the head
    under ``bbox_head``, or under the legacy ``roi_heads`` / ``rpn_net``
    (the first that is not None), each a module or its config section.
    The head section goes through ``compat.adapt_single_stage_head``.
    ``pretrained`` is read by the runner. The activations run in the
    parameters' dtype (``compute_dtype`` None: the JAX network has no
    such field)."""

    compute_dtype = None
    default_head = S2ANetHead

    def __init__(self, backbone=None, neck=None, bbox_head=None,
                 roi_heads=None, rpn_net=None, pretrained=None):
        super().__init__()
        # the head section first: an unported head names its item
        # before the backbone is built
        head = adapt_single_stage_head(next(
            (h for h in (bbox_head, roi_heads, rpn_net) if h is not None),
            None))
        self.backbone = _build(backbone, BACKBONES, _resnet50)
        self.neck = _build(neck, NECKS, _fpn)
        self.bbox_head = _build(head, HEADS, self.default_head)

    def extract_feats(self, images):
        """images NHWC -> the neck's levels, NHWC."""
        return self.neck(self.backbone(images.to(next(
            self.parameters()).dtype)))

    def loss(self, images, targets, generator=None) -> Dict[str, torch.Tensor]:
        """Training losses of normalized NHWC ``images`` (call in train
        mode); ``targets`` as the head's ``loss`` reads them. The head
        samples nothing, so ``generator`` is unused."""
        return self.bbox_head.loss(
            self.bbox_head(self.extract_feats(images), train=True), targets)

    @torch.inference_mode()
    def predict(self, images, scale_factor: Optional[torch.Tensor] = None):
        """Eval-mode detections of normalized NHWC images: the head's
        ``get_bboxes`` dict (polys, scores, labels, valid); boxes divided
        by ``scale_factor`` [B] (default 1) where the head reads it (SSD's
        does not)."""
        if scale_factor is None:
            scale_factor = torch.ones(images.shape[0], device=images.device)
        outs = self.bbox_head(self.extract_feats(images), train=False)
        return self.bbox_head.get_bboxes(outs, scale_factor)


@MODELS.register_module()
class S2ANet(SingleStageDetector):
    """Reference ``networks/s2anet.py:7-37``."""


@MODELS.register_module()
class RetinaNet(SingleStageDetector):
    """Reference ``networks/retinanet.py:9``: the head under ``rpn_net``
    (the legacy creator form) or ``bbox_head``."""


@MODELS.register_module()
class FCOS(SingleStageDetector):
    """Reference ``networks/fcos.py:4``: the ``FCOSHead`` under
    ``roi_heads`` or ``bbox_head``."""


@MODELS.register_module()
class SSD(SingleStageDetector):
    """The JAX ``SSD`` (``roi_heads/ssd_head.py``): ``SSD_VGG16``,
    ``SSDNeck`` and ``SSDHead``, as the zoo's ``SingleStageDetector``
    sections build them too."""


# the YOLOv5 networks (``projects/yolo``) wait for their family
register_unported(MODELS, ("YOLO", "YOLOv5S", "YOLOv5M", "YOLOv5L",
                           "YOLOv5X"), "the network", "11f")
