"""Gliding Vertex (counterpart of
``rs_detection_tpu/models/networks/gliding_vertex.py``): the ``RCNN``
two-stage detector with the hbb ``GlidingRPNHead`` and the
``GlidingHead`` second stage, whose detections are quads."""

from __future__ import annotations

from ...utils.registry import MODELS
from ..roi_heads.gliding_head import GlidingHead
from ..roi_heads.rpn_head import GlidingRPNHead
from .rcnn import RCNN


@MODELS.register_module()
class GlidingVertex(RCNN):
    """Backbone, FPN, ``GlidingRPNHead`` and ``GlidingHead`` by default;
    it reads no legacy section, not even ``rpn_head`` (the JAX network
    builds its RPN from ``rpn`` alone). The targets need "hboxes" and
    "polys"."""

    reads_rpn_head = False
    default_rpn = GlidingRPNHead
    default_head = GlidingHead
