"""RoI-Transformer and FasterRCNN-OBB (counterpart of
``rs_detection_tpu/models/networks/roi_transformer.py``): the hbb
``RPNHead`` and the ``RoITransformerHead`` cascade, two stages or
(FasterRCNN-OBB) one. A config in the mmdet-v1 schema (``rpn_head``,
``bbox_roi_extractor``, ``rbbox_head``, ``train_cfg``, ...) folds onto
those two heads through ``compat.adapt_rpn_cfg`` and
``compat.adapt_cascade_head``; a modern one passes ``rpn`` and
``bbox_head`` straight through."""

from __future__ import annotations

from collections.abc import Mapping

from ...utils.registry import HEADS, MODELS, build_from_cfg
from ..roi_heads.rbbox_head import RoITransformerHead
from ..roi_heads.rpn_head import RPNHead
from .compat import adapt_cascade_head, normalize_cfg
from .rcnn import RCNN, _build


def _head_cfg(bbox_head, legacy):
    """The head section: the legacy cascade sections folded into one
    ``RoITransformerHead`` section when any is there (or the head section
    carries ``roi_feat_size``), else ``bbox_head`` as it is."""
    if (legacy["rbbox_head"] is not None
            or legacy["bbox_roi_extractor"] is not None
            or (isinstance(bbox_head, Mapping)
                and "roi_feat_size" in bbox_head)):
        return adapt_cascade_head(bbox_head, legacy["rbbox_head"],
                                  legacy["bbox_roi_extractor"],
                                  legacy["rbbox_roi_extractor"],
                                  legacy["train_cfg"])
    return bbox_head


@MODELS.register_module()
class RoITransformer(RCNN):
    """hbb RPN + the two-stage rotated cascade."""

    LEGACY = ("rpn_head", "bbox_roi_extractor", "rbbox_roi_extractor",
              "rbbox_head", "train_cfg", "test_cfg")
    default_rpn = RPNHead
    default_head = RoITransformerHead

    def build_head(self, bbox_head, legacy):
        return _build(_head_cfg(bbox_head, legacy), HEADS, self.default_head)


@MODELS.register_module()
class FasterRCNNOBB(RoITransformer):
    """hbb RPN + one shared-FC stage on horizontal RoIAlign regressing
    rotated boxes: the cascade head with ``num_stages=1``, also where a
    modern config's head section asks for two, as in JAX."""

    @staticmethod
    def default_head():
        return RoITransformerHead(num_stages=1)

    def build_head(self, bbox_head, legacy):
        cfg = _head_cfg(bbox_head, legacy)
        head = _build(cfg, HEADS, self.default_head)
        if isinstance(head, RoITransformerHead) and head.num_stages != 1:
            head = build_from_cfg(dict(normalize_cfg(cfg, HEADS),
                                       num_stages=1), HEADS)
        return head

