"""IoU calculators by config name (counterpart of
``rs_detection_tpu/models/boxes/iou_calculator.py``): pairwise hbb IoU
through ``ops/nms.py:bbox_overlaps_hbb``, rotated IoU through
``ops/rotated_iou.py:box_iou_rotated``. Batched over leading axes."""

from __future__ import annotations

import numpy as np
import torch

from ...ops.nms import bbox_overlaps_hbb
from ...ops.rotated_iou import box_iou_rotated
from ...utils.registry import BOXES


@BOXES.register_module()
class BboxOverlaps2D:
    """hbb IoU (``mode="iof"``: over the area of ``bboxes1``)."""

    def __call__(self, bboxes1, bboxes2, mode: str = "iou",
                 is_aligned: bool = False):
        if is_aligned:
            raise NotImplementedError("BboxOverlaps2D: aligned mode is not "
                                      "ported; no caller uses it")
        return bbox_overlaps_hbb(bboxes1[..., :4], bboxes2[..., :4], mode)


@BOXES.register_module()
class BboxOverlaps2D_v1(BboxOverlaps2D):
    pass


@BOXES.register_module()
class BboxOverlaps2D_rotated:
    """Exact rotated IoU of (cx, cy, w, h, theta) boxes."""

    def __call__(self, bboxes1, bboxes2, mode: str = "iou",
                 is_aligned: bool = False):
        if is_aligned:
            raise NotImplementedError("BboxOverlaps2D_rotated: aligned mode "
                                      "is not ported; no caller uses it")
        return box_iou_rotated(bboxes1[..., :5], bboxes2[..., :5], mode=mode)


@BOXES.register_module()
class BboxOverlaps2D_rotated_v1(BboxOverlaps2D_rotated):
    pass


def bbox_overlaps_np(bboxes1, bboxes2, mode="iou"):
    """numpy hbb IoU [N, 4] x [M, 4] -> [N, M] f32, through
    ``bbox_overlaps_hbb`` on the CPU."""
    return bbox_overlaps_hbb(
        torch.from_numpy(np.asarray(bboxes1, np.float32)),
        torch.from_numpy(np.asarray(bboxes2, np.float32)), mode).numpy()
