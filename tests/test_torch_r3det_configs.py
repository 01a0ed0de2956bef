"""The R3Det zoo config (``projects/r3det/configs/r3det_r50_fpn_1x_dota.py``)
in the port against the JAX package: it loads to the same tree, its
``RRetinaHead`` section adapts as the JAX ``adapt_retina_like`` folds it
and its first ``RRetinaRefineHead`` as ``adapt_refine_head``, and it
builds at full width on the meta device with the JAX network's
parameter count. Then the zoo as a whole: the 7 YOLO configs build
(item 11f, ported since), and 76 of the 80 model configs build. CPU."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.config.config import Config as JConfig
from rs_detection_tpu.models.networks import compat as jcompat
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config.config import Config
from rs_detection_tpu_torch.models.networks import compat
from rs_detection_tpu_torch.models.networks.r3det import (
    FeatureRefineModule, R3DetRefineHead)
from rs_detection_tpu_torch.models.roi_heads.retina_head import RetinaHead
from rs_detection_tpu_torch.runner import runner  # noqa: F401  (registries)
from rs_detection_tpu_torch.utils import registry as reg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R3DET = os.path.join(REPO, "projects", "r3det", "configs",
                     "r3det_r50_fpn_1x_dota.py")
HEAD_FIELDS = ("num_classes", "in_channels", "feat_channels",
               "stacked_convs", "anchor_strides", "anchor_ratios",
               "octave_base_scale", "scales_per_octave", "anchor_angles",
               "target_means", "target_stds", "focal_gamma", "focal_alpha",
               "smooth_l1_beta", "nms_pre", "score_thr", "nms_iou_thr",
               "max_per_img", "pos_iou_thr", "neg_iou_thr", "min_pos_iou")


def test_config_loads_like_jax():
    assert Config(R3DET).dump() == JConfig(R3DET).dump()


def test_head_sections_adapt_like_jax():
    """The ``RRetinaHead`` section through ``adapt_single_stage_head``
    equals the JAX ``adapt_retina_like`` (16 classes with the background,
    3 octave scales x 7 ratios on strides 8-128, the angles left at 0,
    beta 0.11) and normalizes to the same kwargs; the first
    ``RRetinaRefineHead`` equals the JAX ``adapt_refine_head`` (16
    classes, four convs a branch). ``use_h_gt`` and the loss weights are
    dropped in both."""
    m, jm = Config(R3DET).model, JConfig(R3DET).model
    got = compat.adapt_single_stage_head(m["bbox_head"])
    assert got == jcompat.adapt_retina_like(jm["bbox_head"])
    assert got == dict(
        type="RetinaHead", num_classes=16, in_channels=256,
        feat_channels=256, stacked_convs=4, octave_base_scale=4,
        scales_per_octave=3, anchor_ratios=[1.0, 0.5, 2.0, 1 / 3, 3.0, 0.2,
                                            5.0],
        anchor_strides=[8, 16, 32, 64, 128], target_means=[0.0] * 5,
        target_stds=[1.0] * 5, focal_gamma=2.0, focal_alpha=0.25,
        smooth_l1_beta=0.11)
    assert json.loads(json.dumps(compat.normalize_cfg(got, reg.HEADS))) == \
        json.loads(json.dumps(jcompat.normalize_cfg(
            jcompat.adapt_retina_like(jm["bbox_head"]), jreg.HEADS)))
    refine = compat.adapt_refine_head(m["refine_heads"][0])
    assert refine == jcompat.adapt_refine_head(jm["refine_heads"][0])
    assert (refine["num_classes"], refine["stacked_convs"]) == (16, 4)


def test_legacy_head_adapters_match_jax_on_every_key():
    """``adapt_retina_like`` with angles and every optional key, and
    ``adapt_refine_head`` with no ``num_classes`` (the fallback's 15 +
    1), equal to JAX's."""
    sec = dict(type="RRetinaHead", num_classes=4, in_channels=32,
               anchor_generator=dict(octave_base_scale=2,
                                     scales_per_octave=2, ratios=[1.0],
                                     strides=[4, 8], angles=[0.0, 0.5]),
               bbox_coder=dict(target_means=[0.1] * 5,
                               target_stds=[0.5] * 5),
               loss_cls=dict(gamma=1.5, alpha=0.3), loss_bbox=dict(beta=0.2))
    assert compat.adapt_retina_like(sec) == jcompat.adapt_retina_like(sec)
    for r in (dict(type="RRetinaRefineHead"),
              dict(type="RRetinaRefineHead", num_classes=3,
                   bbox_coder=dict(target_stds=[0.2] * 5))):
        assert compat.adapt_refine_head(r) == jcompat.adapt_refine_head(r)


def test_config_builds_at_full_width():
    """ResNet-50, FPN-256 from C3 with ``on_input`` extra convs, the
    ``RetinaHead`` with every value the JAX head receives (21 anchors a
    position), one ``R3DetRefineHead`` (its assigner 0.6 / 0.5) and one
    ``FeatureRefineModule`` (1 point) from the lists' first entries; the
    parameters and the BatchNorms' running statistics count what the JAX
    network's variables count, 45,622,392."""
    m = Config(R3DET).model
    with torch.device("meta"):
        model = reg.build_from_cfg(m, reg.MODELS)
    assert type(model).__name__ == "R3Det"
    assert model.neck.start_level == 1
    h = model.bbox_head
    assert isinstance(h, RetinaHead) and h.num_anchors == 21
    jh = jreg.build_from_cfg(jcompat.normalize_cfg(
        jcompat.adapt_retina_like(JConfig(R3DET).model["bbox_head"]),
        jreg.HEADS), jreg.HEADS)
    ag = h.anchor_gens[0]
    got = {"num_classes": h.num_classes, "in_channels": h.cls_0.in_channels,
           "feat_channels": h.feat_channels,
           "stacked_convs": h.stacked_convs,
           "anchor_strides": h.anchor_strides,
           "anchor_ratios": tuple(ag.ratios),
           "octave_base_scale": ag.scales[0],
           "scales_per_octave": len(ag.scales),
           "anchor_angles": tuple(ag.angles),
           "target_means": h.target_means, "target_stds": h.target_stds,
           "focal_gamma": h.focal_gamma, "focal_alpha": h.focal_alpha,
           "smooth_l1_beta": h.smooth_l1_beta, "nms_pre": h.nms_pre,
           "score_thr": h.score_thr, "nms_iou_thr": h.nms_iou_thr,
           "max_per_img": h.max_per_img,
           "pos_iou_thr": h.assigner.pos_iou_thr,
           "neg_iou_thr": h.assigner.neg_iou_thr,
           "min_pos_iou": h.assigner.min_pos_iou}
    for f in HEAD_FIELDS:
        want = getattr(jh, f)
        if isinstance(want, (list, tuple)):
            np.testing.assert_allclose(np.asarray(got[f], np.float64),
                                       np.asarray(want, np.float64),
                                       rtol=1e-6, err_msg=f)
        else:
            assert got[f] == pytest.approx(want), (f, got[f], want)
    r = model.refine_head
    assert isinstance(r, R3DetRefineHead) and r.stacked_convs == 4
    assert (r.assigner.pos_iou_thr, r.assigner.neg_iou_thr) == (0.6, 0.5)
    assert isinstance(model.frm, FeatureRefineModule)
    assert model.frm.points == 1
    count = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for n, b in model.named_buffers()
        if n.endswith(("running_mean", "running_var")))
    jm = jreg.build_from_cfg(JConfig(R3DET).model, jreg.MODELS)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 256, 256, 3))))
    assert count == sum(int(np.prod(a.shape))
                        for a in jax.tree_util.tree_leaves(v)) == 45622392


YOLO = sorted(p for p in glob.glob(os.path.join(REPO, "projects", "yolo",
                                                "configs", "*.py"))
              if not p.endswith("_base.py"))


YOLO_PARAMS = {"yolo_test": 7235389, "yolov5s_coco128_300epoch_ema": 7235389,
               "yolov5s_coco_12epoch_ema": 7235389,
               "yolov5m_coco_12epoch_ema": 21190557,
               "yolov5l_coco_12epoch_ema": 46563709,
               "yolov5x_coco_12epoch_ema": 86749405,
               "yolov5s_dota": 7060084}


@pytest.mark.parametrize("path", YOLO, ids=lambda p: os.path.basename(p)[:-3])
def test_yolo_configs_raise_with_their_item(path):
    """The 7 YOLO configs (``YOLO``, ``YOLOv5S`` / ``M`` / ``L`` / ``X``)
    waited for item 11f, which raised naming it; since it was ported
    (the name is kept) each builds on the meta device with the JAX
    network's parameter count (``tests/test_torch_yolo_configs.py``
    checks them against the JAX package)."""
    assert len(YOLO) == 7
    with torch.device("meta"):
        model = reg.build_from_cfg(Config(path).model, reg.MODELS)
    assert sum(p.numel() for p in model.parameters()) == \
        YOLO_PARAMS[os.path.basename(path)[:-3]]


def test_the_zoo_builds_67_of_80_model_configs():
    """Every model config under ``configs/`` and ``projects/*/configs/``
    (the preprocess configs and the 4 YOLO ``*_base.py`` fragments hold
    none) on the meta device: 76 build since the YOLO family (67 after
    R3Det, whence the name; 69 after SSD); the 4 others raise the
    ``KeyError`` they raise in JAX: the 3 ``*_r2_*`` S2ANet configs and
    the ConvNeXt RoI-Transformer (``Convnext_xlarge``, which neither
    package registers). None raises "not ported"."""
    paths = sorted(
        glob.glob(os.path.join(REPO, "configs", "**", "*.py"),
                  recursive=True)
        + glob.glob(os.path.join(REPO, "projects", "*", "configs", "**",
                                 "*.py"), recursive=True))
    built, key_errors = 0, []
    for p in paths:
        if p.endswith("_base.py") or "/preprocess/" in p:
            continue
        m = Config(p).model
        assert m, p
        try:
            with torch.device("meta"):
                reg.build_from_cfg(m, reg.MODELS)
            built += 1
        except KeyError:
            key_errors.append(os.path.basename(p))
    assert built + len(key_errors) == 80
    assert built == 76
    assert len(key_errors) == 4
    assert sorted(k for k in key_errors if "_r2_" not in k) == [
        "RoITrans_convnext_xlarge_5e-5.py"]
