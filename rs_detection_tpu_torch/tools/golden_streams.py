"""The golden-loss streams of the port: the nine tiny families of
``tests/test_golden_loss.py`` as the port builds them, their batch, and
four SGD steps (lr 0.01, momentum 0.9, clip 35) of ``train_step``.

``tests/test_torch_golden_loss.py`` holds these streams, from the JAX
init, to the recorded fixtures ``tests/fixtures/golden_losses_<name>.json``
(or to the JAX stream); ``chip_smoke.py`` phase 59b runs them on the card
from the port's own seeded init against the CPU; ``tools/test_models.py``
runs the test file family by family.

Every family is ResNet-18 (train-mode BN) + a 32-wide FPN, or the SSD /
YOLO defaults, on one 64^2 image of ``RandomState(42)`` noise with two
ground truths. The RoI samplers of ``orcnn``, ``gliding`` and
``roitrans`` draw at random: ``host_draws`` makes every device draw the
same numbers (on the CPU, from one seeded generator) so that two devices
run the same stream.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

IMG = 64
STEPS = 4
FAMILIES = ("fcos", "gliding", "orcnn", "r3det", "retinanet", "roitrans",
            "s2anet", "ssd", "yolo")
# the families whose training draws at random (their RoI samplers)
SAMPLING = ("gliding", "orcnn", "roitrans")

_RES = dict(type="ResNet", depth=18, norm_eval=False)
_ROI = dict(roi_layer=dict(output_size=7, sampling_ratio=2), out_channels=32,
            featmap_strides=[4, 8, 16, 32])


def _fpn(extra_convs=True):
    cfg = dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32,
               num_outs=5)
    if extra_convs:
        cfg["add_extra_convs"] = "on_input"
    return cfg


def model_cfg(name: str) -> Dict:
    """The family's model config: the arguments of its JAX build
    function (``tests/test_golden_loss.py:build_<name>``)."""
    return {
        "orcnn": dict(
            type="OrientedRCNN", backbone=_RES, neck=_fpn(False),
            rpn=dict(type="OrientedRPNHead", in_channels=32,
                     feat_channels=32, nms_pre=64, nms_post=32,
                     pre_nms_cap=128, sampler=dict(num=32, pos_fraction=0.5)),
            bbox_head=dict(type="OrientedHead", num_classes=3, in_channels=32,
                           fc_out_channels=64,
                           sampler=dict(num=16, pos_fraction=0.25),
                           bbox_roi_extractor=dict(_ROI,
                                                   extend_factor=(1.4, 1.2)))),
        "s2anet": dict(
            type="S2ANet", backbone=_RES, neck=_fpn(),
            bbox_head=dict(type="S2ANetHead", num_classes=3, in_channels=32,
                           feat_channels=32,
                           anchor_strides=(4, 8, 16, 32, 64), nms_pre=32,
                           max_per_img=16)),
        "retinanet": dict(
            type="RetinaNet", backbone=_RES, neck=_fpn(),
            bbox_head=dict(type="RetinaHead", num_classes=3, in_channels=32,
                           feat_channels=32)),
        "fcos": dict(
            type="FCOS", backbone=_RES, neck=_fpn(),
            bbox_head=dict(type="FCOSHead", num_classes=3, in_channels=32,
                           feat_channels=32, stacked_convs=2,
                           strides=(4, 8, 16, 32, 64),
                           regress_ranges=((-1, 16), (16, 32), (32, 64),
                                           (64, 128), (128, 1e8)),
                           nms_pre=32, max_per_img=16)),
        "gliding": dict(
            type="GlidingVertex", backbone=_RES, neck=_fpn(),
            rpn=dict(type="GlidingRPNHead", in_channels=32, feat_channels=32,
                     nms_pre=64, nms_post=32),
            bbox_head=dict(type="GlidingHead", num_classes=15,
                           in_channels=32, fc_out_channels=64,
                           sampler=dict(num=16, pos_fraction=0.25),
                           bbox_roi_extractor=_ROI)),
        "roitrans": dict(
            type="RoITransformer", backbone=_RES, neck=_fpn(),
            rpn=dict(type="RPNHead", in_channels=32, feat_channels=32,
                     nms_pre=64, nms_post=32),
            bbox_head=dict(type="RoITransformerHead", num_classes=15,
                           in_channels=32, sampler_num=16, pos_fraction=0.25,
                           featmap_strides=[4, 8, 16, 32])),
        "r3det": dict(
            type="R3Det", backbone=_RES, neck=_fpn(),
            bbox_head=dict(type="RetinaHead", num_classes=4, in_channels=32,
                           feat_channels=32)),
        "ssd": dict(type="SSD", backbone=dict(type="SSDVGG"),
                    neck=dict(type="SSDNeck"),
                    bbox_head=dict(type="SSDHead", num_classes=4)),
        "yolo": dict(type="YOLO",
                     bbox_head=dict(type="YOLOv5Head", num_classes=4)),
    }[name]


def build(name: str):
    """The family's model through the port's registry (unseeded)."""
    from ..runner import runner as _runner  # noqa: F401  (registries)
    from ..utils.registry import MODELS, build_from_cfg

    return build_from_cfg(model_cfg(name), MODELS)


def inputs(name: str):
    """The batch of the JAX build function as numpy: one 64^2 image of
    uniform noise (``RandomState(42)``, not normalized) and two ground
    truths in 8 slots; ``gliding``, ``roitrans``, ``r3det``, ``ssd`` and
    ``yolo`` (``_rich_targets`` on the JAX side) also get their quads
    (the best begin point first) and hbbs."""
    from ..ops.box_ops import rotated_box_to_poly_np

    images = np.random.RandomState(42).rand(1, IMG, IMG, 3).astype(
        np.float32)
    rboxes = np.zeros((1, 8, 5), np.float32)
    rboxes[0, 0] = [30, 30, 20, 10, 0.3]
    rboxes[0, 1] = [45, 40, 12, 6, -0.5]
    gt_mask = np.zeros((1, 8), bool)
    gt_mask[0, :2] = True
    labels = np.zeros((1, 8), np.int32)
    labels[0, :2] = [1, 2]
    targets = dict(rboxes=rboxes, gt_mask=gt_mask, labels=labels,
                   img_hw=np.asarray([[IMG, IMG]], np.float32),
                   scale_factor=np.ones((1,), np.float32))
    if name in ("gliding", "roitrans", "r3det", "ssd", "yolo"):
        polys = rotated_box_to_poly_np(rboxes.reshape(-1, 5)).reshape(1, 8, 8)
        targets["polys"] = polys
        targets["hboxes"] = np.stack(
            [polys[..., 0::2].min(-1), polys[..., 1::2].min(-1),
             polys[..., 0::2].max(-1), polys[..., 1::2].max(-1)], -1)
    return images, targets


# the CPU generator the samplers draw from inside ``host_draws``
_HOST = None


@contextlib.contextmanager
def host_draws():
    """Within the context every RoI sampler draws its uniform scores on
    the CPU from one generator, which each ``Stream.step`` seeds from its
    step's number, and moves them to the sampled tensor's device: step k
    of a stream draws the same numbers on every device."""
    global _HOST
    from ..models.boxes import sampler as sm

    real = sm.dist

    class _Dist:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def rand_rows(shape, generator=None, device=None):
            return real.rand_rows(shape, _HOST).to(device)

    sm.dist, _HOST = _Dist(), torch.Generator()
    try:
        yield
    finally:
        sm.dist, _HOST = real, None


class Stream:
    """SGD steps (lr 0.01, momentum 0.9, clip 35, decay 1e-4, constant
    rate) of ``train_step`` on ``model``, moved to ``device`` and
    ``dtype``, over the numpy batch. The samplers draw from a generator
    seeded 3 on ``device`` (``host_draws`` overrides it)."""

    def __init__(self, model, images, targets, device="cpu",
                 dtype=torch.float32):
        from ..optims.optimizer import SGD

        self.model = model.to(device=device, dtype=dtype)
        self.device = device
        self.x = torch.from_numpy(np.array(images)).to(device, dtype)
        self.targets = {
            k: (v.to(dtype) if v.is_floating_point() else v) for k, v in (
                (k, torch.from_numpy(np.array(a)).to(device))
                for k, a in targets.items())}
        self.opt = SGD(model.parameters(), lr=0.01, momentum=0.9,
                       grad_clip=dict(max_norm=35))
        self.steps = 0

    def step(self) -> float:
        """One step; its total loss."""
        from ..parallel.train_step import train_step
        from ..runner.runner import constant_lr

        if _HOST is not None:
            _HOST.manual_seed(1000 + self.steps)
        losses = train_step(self.model, self.opt, constant_lr, self.x,
                            self.targets,
                            torch.Generator(device=self.device).manual_seed(3),
                            epoch=0.0)
        self.steps += 1
        return float(losses["total_loss"])

    @torch.no_grad()
    def take_state(self, other: "Stream") -> None:
        """``other``'s parameters, buffers and momentum in place of this
        stream's (on this stream's device)."""
        for mine, theirs in zip(self.model.state_dict().values(),
                                other.model.state_dict().values()):
            mine.copy_(theirs)
        for p, q in zip(self.model.parameters(), other.model.parameters()):
            buf = other.opt.state.get(q, {}).get("momentum_buffer")
            if buf is not None:
                self.opt.state[p]["momentum_buffer"] = buf.to(
                    p.device, p.dtype, copy=True)


def stream(model, images, targets, device="cpu", steps: int = STEPS,
           dtype=torch.float32) -> List[float]:
    """``steps`` steps of a ``Stream``: the total losses."""
    s = Stream(model, images, targets, device, dtype)
    return [s.step() for _ in range(steps)]
