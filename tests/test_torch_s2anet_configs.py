"""The 16 S2ANet zoo configs in the port against the JAX package: the 19
of ``configs/s2anet_r50_fpn_1x_dota.py``, ``configs/s2anet/`` and
``projects/s2anet/configs/`` less the 3 that name a Res2Net backbone,
which builds in neither package. Each loads to the same tree, its head
section normalizes (``compat.adapt_single_stage_head``) to the same
kwargs as in JAX, each builds at full width with the values the JAX
constructors receive in its modules (on the meta device), and each
config's tiny form (Resnet18 with the config's freezing, a 32-wide FPN
from the config's start level, the 32-wide head with the config's
classes, anchors, coder and thresholds) gives the JAX one's dense
outputs from the same weights. The values of the ``loss_*``,
``test_cfg`` and ``train_cfg`` sections that reach the head, and those
that are dropped, are pinned. CPU, f32."""

import copy
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
from rs_detection_tpu_torch.flagship import normalize
from rs_detection_tpu_torch.models.networks import compat
from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.models.roi_heads.s2anet_head import (
    ORConv2d, S2ANetHead)
from rs_detection_tpu_torch.models.roi_heads.ssd_head import SSDHead
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL = ([os.path.join(REPO, "configs", "s2anet_r50_fpn_1x_dota.py")]
       + sorted(glob.glob(os.path.join(REPO, "configs", "s2anet", "*.py")))
       + sorted(glob.glob(os.path.join(REPO, "projects", "s2anet", "configs",
                                       "*.py"))))
RES2NET = [p for p in ALL if "_r2_" in os.path.basename(p)]
CONFIGS = [p for p in ALL if p not in RES2NET]
IDS = [os.path.relpath(p, REPO).replace("/", ":")[:-3] for p in CONFIGS]
DEPTH = {"Resnet50": 50, "Resnet101": 101}
BLOCKS = {50: 16, 101: 33}
HEAD_FIELDS = ("num_classes", "stacked_convs", "with_orconv",
               "anchor_scales", "anchor_ratios", "anchor_strides",
               "target_means", "target_stds", "focal_gamma", "focal_alpha",
               "smooth_l1_beta", "nms_pre", "score_thr", "nms_iou_thr",
               "max_per_img", "pos_iou_thr", "neg_iou_thr", "min_pos_iou")


def test_the_slice_has_16_configs():
    assert len(ALL) == 19 and len(RES2NET) == 3 and len(CONFIGS) == 16


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_loads_like_jax(path):
    assert Config(path).dump() == JConfig(path).dump()


def _head_kwargs(model, lib):
    """The head section as ``lib`` (the port's compat or the JAX one)
    hands it to the head's constructor."""
    return lib.normalize_cfg(lib.adapt_single_stage_head(model["bbox_head"]),
                             (reg if lib is compat else jreg).HEADS)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_head_section_normalizes_like_jax(path):
    got = _head_kwargs(Config(path).model, compat)
    want = _head_kwargs(JConfig(path).model, jcompat)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def _jax_head(model):
    """The JAX head module as the JAX network's setup builds it (an
    unbound flax module: its fields are the constructor's values)."""
    return jreg.build_from_cfg(_head_kwargs(model, jcompat), jreg.HEADS)


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_builds_at_full_width(path):
    """ResNet-50 / -101 with the config's freezing, FPN-256 from its
    start level with ``on_input`` extra convs, and the head with every
    value the JAX head receives."""
    m = Config(path).model
    with torch.device("meta"):
        model = reg.build_from_cfg(m, reg.MODELS)
    assert type(model).__name__ == "S2ANet"
    depth = DEPTH[m["backbone"]["type"]]
    assert sum(model.backbone.layers) == BLOCKS[depth]
    assert model.backbone.frozen_stages == m["backbone"]["frozen_stages"]
    neck = model.neck
    assert neck.in_channels == (256, 512, 1024, 2048)
    assert neck.start_level == m["neck"].get("start_level", 0)
    assert neck.add_extra_convs == "on_input" and neck.num_outs == 5
    h, jh = model.bbox_head, _jax_head(JConfig(path).model)
    assert isinstance(h, S2ANetHead)
    for f in HEAD_FIELDS:
        want = getattr(jh, f)
        got = {"num_classes": h.num_classes,
               "stacked_convs": h.stacked_convs,
               "with_orconv": h.with_orconv,
               "anchor_scales": tuple(h.anchor_gens[0].scales),
               "anchor_ratios": tuple(h.anchor_gens[0].ratios),
               "anchor_strides": h.anchor_strides,
               "target_means": h.target_means, "target_stds": h.target_stds,
               "focal_gamma": h.focal_gamma, "focal_alpha": h.focal_alpha,
               "smooth_l1_beta": h.smooth_l1_beta, "nms_pre": h.nms_pre,
               "score_thr": h.score_thr, "nms_iou_thr": h.nms_iou_thr,
               "max_per_img": h.max_per_img,
               "pos_iou_thr": h.assigner.pos_iou_thr,
               "neg_iou_thr": h.assigner.neg_iou_thr,
               "min_pos_iou": h.assigner.min_pos_iou}[f]
        if isinstance(want, (list, tuple)):
            np.testing.assert_allclose(np.asarray(got, np.float64),
                                       np.asarray(want, np.float64),
                                       err_msg=f)
        else:
            assert got == want, (f, got, want)
    assert isinstance(h.or_conv, ORConv2d)
    assert h.or_conv.weight.shape == (32, 256, 9)
    assert h.fam_cls_out.out_channels == jh.num_classes - 1
    assert h.align_conv.weight.shape == (256, 256, 3, 3)
    assert h.assigner.rotated


BS8 = os.path.join(REPO, "projects", "s2anet", "configs",
                   "s2anet_r50_fpn_1x_dota_bs8.py")


def test_pinned_values_of_the_head_sections():
    """``s2anet_r50_fpn_1x_dota_bs8.py``: the loss sections reach the head
    as focal gamma / alpha and the smooth-L1 beta (their ``loss_weight``
    is dropped), ``test_cfg`` as ``nms_pre``, ``score_thr``,
    ``max_per_img`` and the NMS IoU (``min_bbox_size`` dropped),
    ``train_cfg`` as the FAM assigner's three thresholds (``odm_cfg``,
    ``pos_weight``, ``allowed_border`` and the coder dropped); the same
    in both packages. Where the FAM and ODM loss sections differ, the
    later one in the section's order wins in both."""
    kw = _head_kwargs(Config(BS8).model, compat)
    assert kw == dict(
        type="S2ANetHead", anchor_ratios=[1.0], anchor_scales=[4],
        anchor_strides=[8, 16, 32, 64, 128], feat_channels=256,
        in_channels=256, num_classes=16, stacked_convs=2,
        target_means=[0.0] * 5, target_stds=[1.0] * 5, with_orconv=True,
        focal_gamma=2.0, focal_alpha=0.25, smooth_l1_beta=1 / 9,
        max_per_img=2000, nms_pre=2000, score_thr=0.05, nms_iou_thr=0.1,
        pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0)
    sec = copy.deepcopy(Config(BS8).model["bbox_head"])
    sec["loss_fam_cls"].update(gamma=1.0, alpha=0.5)
    sec["loss_odm_bbox"].update(beta=0.5)
    sec["train_cfg"]["odm_cfg"]["assigner"]["pos_iou_thr"] = 0.7
    sec["train_cfg"]["fam_cfg"]["assigner"]["neg_iou_thr"] = 0.3
    got = compat.normalize_cfg(compat.adapt_single_stage_head(sec),
                               reg.HEADS)
    want = jcompat.normalize_cfg(jcompat.adapt_single_stage_head(sec),
                                 jreg.HEADS)
    assert got == want
    assert (got["focal_gamma"], got["focal_alpha"]) == (2.0, 0.25)
    assert got["smooth_l1_beta"] == 0.5
    assert (got["pos_iou_thr"], got["neg_iou_thr"]) == (0.5, 0.3)


@pytest.mark.parametrize("path", RES2NET,
                         ids=lambda p: os.path.basename(p)[:-3])
def test_res2net_configs_build_in_neither_package(path):
    """Their backbone names no registered class in JAX; the port raises
    the same ``KeyError`` and adds no alias."""
    bb = Config(path).model["backbone"]["type"]
    assert bb.startswith("res2net")
    with pytest.raises(KeyError):
        jreg.BACKBONES.get(bb)
    with torch.device("meta"), pytest.raises(KeyError,
                                             match="not registered"):
        reg.build_from_cfg(Config(path).model, reg.MODELS)


def tiny_form(model):
    """A config's model section cut to a CPU test's size: Resnet18 with
    the config's freezing, a 32-wide FPN (its start level and extra-conv
    mode), the 32-wide head with 32 candidates a level and 16 detection
    slots; classes, anchors, coder and thresholds as the config has
    them."""
    m = copy.deepcopy(dict(model))
    bb = dict(m["backbone"])
    bb.pop("depth", None)
    bb["type"] = "Resnet18"
    m["backbone"] = bb
    m["neck"] = dict(m["neck"], in_channels=[64, 128, 256, 512],
                     out_channels=32)
    m["bbox_head"] = dict(m["bbox_head"], in_channels=32, feat_channels=32,
                          nms_pre=32, max_per_img=16)
    return m


_JAX_OUTS = {}


def _dense(m, images):
    """The network's dense outputs in eval mode: per level the FAM box
    deltas, the refined anchors, the ODM scores and box deltas."""
    feats = m.extract_feats(images) if not hasattr(m, "_bbox_head") else \
        m._neck(m._backbone(images, train=False), train=False)
    head = m.bbox_head if not hasattr(m, "_bbox_head") else m._bbox_head
    return head(feats, train=False)[1:]


def _jax_outputs(model, images):
    """The JAX tiny form's perturbed variables and its dense eval-mode
    outputs; one JAX compile for the configs that share a form (decode
    and NMS are held to JAX in ``test_torch_s2anet_modules.py`` and
    ``test_torch_s2anet_networks.py``, whose JAX compile of the whole
    ``predict`` takes 20-60 s a form)."""
    key = json.dumps(model, sort_keys=True, default=str)
    if key not in _JAX_OUTS:
        jm = jreg.build_from_cfg(model, jreg.MODELS)
        x = jnp.asarray(images)
        v = perturb(jax.jit(lambda i: jm.init(
            {"params": jax.random.PRNGKey(0)}, i))(x), seed=6)
        out = jax.jit(lambda v, i: jm.apply(v, i, method=_dense))(v, x)
        _JAX_OUTS[key] = v, jax.tree_util.tree_map(np.asarray, out)
    return _JAX_OUTS[key]


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_tiny_form_outputs_like_jax(path):
    """Every level's FAM deltas, refined anchors, ODM scores and deltas
    (its start level and class count decide the shapes) within 1e-4 of
    each tensor's largest entry (f32 through ResNet-18 with perturbed
    norms, as ``test_torch_s2anet_modules.py``)."""
    model = tiny_form(Config(path).model)
    rng = np.random.RandomState(12)
    tiles = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    images = normalize(torch.from_numpy(tiles))
    variables, ref = _jax_outputs(model, images.numpy())
    port = reg.build_from_cfg(model, reg.MODELS).eval()
    load_jax_variables(port, variables)
    with torch.no_grad():
        got = _dense(port, images)
    nc = Config(path).model["bbox_head"]["num_classes"]
    assert ref[2][0].shape[-1] == nc - 1
    for g_out, r_out in zip(got, ref):
        assert len(g_out) == len(r_out) == 5
        for g_, r_ in zip(g_out, r_out):
            assert g_.shape == r_.shape
            np.testing.assert_allclose(g_.numpy(), r_,
                                       atol=1e-4 * np.abs(r_).max())


OTHER_SINGLE_STAGE = sorted(glob.glob(os.path.join(REPO, "projects", "ssd",
                                                  "configs", "*.py")))


@pytest.mark.parametrize(
    "path", OTHER_SINGLE_STAGE,
    ids=lambda p: os.path.relpath(p, REPO).replace("/", ":")[:-3])
def test_other_single_stage_configs_raise_with_their_item(path):
    """SSD (a ``SingleStageDetector`` with an ``SSDHead``), the last of
    these to wait for item 11 (11e), is ported: each config builds the
    SSD network, never something else (the parity tests are
    ``tests/test_torch_ssd_configs.py``). The RetinaNet and FCOS configs
    build (``tests/test_torch_retinanet_configs.py``,
    ``tests/test_torch_fcos_configs.py``)."""
    with torch.device("meta"):
        model = reg.build_from_cfg(Config(path).model, reg.MODELS)
    assert type(model.backbone).__name__ == "SSDVGG"
    assert isinstance(model.bbox_head, SSDHead)


def test_legacy_single_stage_heads_raise_with_their_item():
    """No legacy single-stage head waits for item 11 any more:
    ``SSDHead`` adapts as the JAX ``_adapt_ssd`` does (``tests/test_
    torch_ssd_configs.py``), R3Det's ``RRetinaHead`` as the JAX
    ``adapt_retina_like`` (``tests/test_torch_r3det_configs.py``), the
    legacy ``RetinaHead`` as the JAX ``_adapt_legacy_retina``
    (``tests/test_torch_retinanet_configs.py``)."""
    ssd = dict(type="SSDHead")
    assert compat.adapt_single_stage_head(ssd) == jcompat._adapt_ssd(ssd)
    rretina = dict(type="RRetinaHead")
    assert compat.adapt_single_stage_head(rretina) == \
        jcompat.adapt_retina_like(rretina)
    legacy = dict(type="RetinaHead", n_class=15)
    assert compat.adapt_single_stage_head(legacy) == \
        jcompat._adapt_legacy_retina(legacy)
