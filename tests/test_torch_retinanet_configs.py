"""The 9 RetinaNet zoo configs (``projects/retinanet/configs``) in the port
against the JAX package: each loads to the same tree, its head section
(the legacy creator-style ``rpn_net`` of 8, the modern ``bbox_head`` of
``retinanet_r50_fpn_1x_dota.py``) adapts and normalizes to the same
kwargs as in JAX (the legacy form through ``_adapt_legacy_retina``),
each builds at full width on the meta device with the values the JAX
head receives, and its optimizer section builds ``GradMutilpySGD`` with
the ``YangXuePrameterGroupsGenerator`` links where the config asks. The
legacy values the JAX adapter drops (``loc_loss_weight`` 0.2,
``cls_loss_weight``) are pinned as dropped. CPU."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.config.config import Config as JConfig
from rs_detection_tpu.models.networks import compat as jcompat
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config.config import Config
from rs_detection_tpu_torch.models import param_generators  # noqa: F401
from rs_detection_tpu_torch.models.networks import compat
from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.models.roi_heads.retina_head import RetinaHead
from rs_detection_tpu_torch.optims import optimizer  # noqa: F401  (OPTIMS)
from rs_detection_tpu_torch.utils import registry as reg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "projects", "retinanet",
                                        "configs", "*.py")))
IDS = [os.path.basename(p)[:-3] for p in CONFIGS]
LEGACY = [p for p in CONFIGS if "rpn_net" in Config(p).model]
HEAD_FIELDS = ("num_classes", "in_channels", "feat_channels",
               "stacked_convs", "anchor_strides", "anchor_ratios",
               "octave_base_scale", "scales_per_octave", "anchor_angles",
               "target_means", "target_stds", "focal_gamma", "focal_alpha",
               "smooth_l1_beta", "nms_pre", "score_thr", "nms_iou_thr",
               "max_per_img", "pos_iou_thr", "neg_iou_thr", "min_pos_iou")


def _section(model):
    return model.get("bbox_head") or model.get("rpn_net")


def test_the_family_has_9_configs():
    assert len(CONFIGS) == 9 and len(LEGACY) == 8


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_loads_like_jax(path):
    assert Config(path).dump() == JConfig(path).dump()


def _head_kwargs(model, lib):
    r = reg if lib is compat else jreg
    return json.loads(json.dumps(lib.normalize_cfg(
        lib.adapt_single_stage_head(_section(model)), r.HEADS)))


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_head_section_adapts_like_jax(path):
    """The adapted section equals the JAX one (the legacy form against
    ``_adapt_legacy_retina``), and normalizes to the same kwargs."""
    sec = _section(Config(path).model)
    got = compat.adapt_single_stage_head(sec)
    if path in LEGACY:
        assert got == jcompat._adapt_legacy_retina(_section(
            JConfig(path).model))
    assert _head_kwargs(Config(path).model, compat) == _head_kwargs(
        JConfig(path).model, jcompat)


def _jax_head(model):
    return jreg.build_from_cfg(_head_kwargs(model, jcompat), jreg.HEADS)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_builds_at_full_width(path):
    """ResNet-50 / -50-v1d, FPN-256 from the config's start level with its
    extra-conv mode, and the head with every value the JAX head
    receives: 126 anchors a position in the legacy configs with angles
    (7 ratios x 3 octave scales x 6 angles in radians), 9 elsewhere."""
    m = Config(path).model
    with torch.device("meta"):
        model = reg.build_from_cfg(m, reg.MODELS)
    assert type(model).__name__ == "RetinaNet"
    assert sum(model.backbone.layers) == 16
    neck = model.neck
    assert neck.start_level == m["neck"].get("start_level", 0)
    assert neck.add_extra_convs == m["neck"]["add_extra_convs"]
    h, jh = model.bbox_head, _jax_head(JConfig(path).model)
    assert isinstance(h, RetinaHead)
    ag = h.anchor_gens[0]
    got = {"num_classes": h.num_classes,
           "in_channels": h.cls_0.in_channels,
           "feat_channels": h.cls_0.out_channels,
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
    angles = _section(m).get("anchor_generator", {}).get("angles")
    assert h.num_anchors == (126 if angles else 9)
    assert h.retina_cls.out_channels == h.num_anchors * (h.num_classes - 1)
    assert h.retina_reg.out_channels == h.num_anchors * 5
    assert h.assigner.rotated


def test_pinned_values_of_the_legacy_section():
    """``retinanet_r50v1d_fpn_dota.py``'s ``rpn_net``: 15 classes plus the
    background, the octave scales 4 x 2^(i/3) recovered from base size 32
    at stride 8, the angles -90..-15 degrees in radians, 10,000
    detections capped at 4,096 slots, ``roi_beta`` as the smooth-L1 beta;
    ``loc_loss_weight`` (0.2) and ``cls_loss_weight`` dropped, in both
    packages."""
    path = os.path.join(REPO, "projects", "retinanet", "configs",
                        "retinanet_r50v1d_fpn_dota.py")
    sec = Config(path).model["rpn_net"]
    assert sec["loc_loss_weight"] == 0.2 and sec["cls_loss_weight"] == 1.0
    kw = compat.adapt_single_stage_head(sec)
    assert kw == jcompat._adapt_legacy_retina(sec)
    assert not any("weight" in k for k in kw)
    assert (kw["num_classes"], kw["octave_base_scale"],
            kw["scales_per_octave"], kw["max_per_img"]) == (16, 4, 3, 4096)
    np.testing.assert_allclose(kw["anchor_angles"],
                               np.deg2rad([-90, -75, -60, -45, -30, -15]))
    assert (kw["score_thr"], kw["nms_iou_thr"]) == (0.05, 0.3)
    assert kw["smooth_l1_beta"] == pytest.approx(1 / 9)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_optimizer_section_builds(path):
    """The config's optimizer with its groups as the runner links them:
    8 ``GradMutilpySGD``, 7 of them with the YangXue links (conv biases x
    2 and decay 0 before the clip, the ``backbone.C1`` stem frozen)."""
    cfg = Config(path)
    with torch.device("meta"):
        model = reg.build_from_cfg(cfg.model, reg.MODELS)
    opt_cfg = dict(cfg.optimizer)
    opt = reg.build_from_cfg(opt_cfg, reg.OPTIMS,
                             params=list(model.named_parameters()))
    assert type(opt).__name__ == opt_cfg["type"]
    pg = cfg.parameter_groups_generator
    if pg:
        wrap = reg.build_from_cfg(dict(pg), reg.MODELS)
        wrap(opt, base_weight_decay=opt_cfg["weight_decay"])
        stem = {id(p) for n, p in model.named_parameters()
                if n.split(".")[1].startswith(("Conv_", "Norm_"))
                and n.startswith("backbone.")}
        assert {id(p) for p in opt.frozen} == stem and len(stem) >= 2
        assert len(opt.grad_links) == 2
    else:
        assert not opt.frozen and not opt.grad_links
