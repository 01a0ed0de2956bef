"""The 6 Gliding Vertex zoo configs (``projects/gliding/configs``) in the
port against the JAX package: each loads to the same tree, its RPN and
head sections normalize to the same kwargs as in JAX, each builds at
full width on the meta device with the values the JAX constructors
receive in its modules, and each config's tiny form (Resnet18 with the
config's freezing, a 32-wide FPN with the config's extra convs, the RPN
and head at 32 channels with the config's anchors, coders, sampler,
assigner and classes) predicts as the JAX one from the same weights. The
loss sections the JAX head drops (``fix_loss`` beta 1/3, ``ratio_loss``
weight 16, ``bbox_loss``, ``cls_loss``) are pinned as dropped. CPU,
f32."""

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
    gliding_vertex  # noqa: F401  (registers the network)
from rs_detection_tpu_torch.models.roi_heads.gliding_head import GlidingHead
from rs_detection_tpu_torch.models.roi_heads.rpn_head import GlidingRPNHead
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "projects", "gliding",
                                        "configs", "*.py")))
IDS = [os.path.basename(p)[:-3] for p in CONFIGS]
BLOCKS = {"Resnet50": 16, "Resnet101": 33}


def test_the_family_has_6_configs():
    assert len(CONFIGS) == 6


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_loads_like_jax(path):
    assert Config(path).dump() == JConfig(path).dump()


def _kwargs(model, lib):
    """The (RPN, head) kwargs ``lib`` (the port's compat or the JAX one)
    hands to the constructors."""
    r = reg if lib is compat else jreg
    return tuple(json.loads(json.dumps(lib.normalize_cfg(model[k], r.HEADS)))
                 for k in ("rpn", "bbox_head"))


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_sections_normalize_like_jax_and_drop_the_loss_sections(path):
    """The same kwargs as in JAX; no loss section reaches the head (its
    four losses are smooth L1 at beta 1 and CE, weight 1), and the RPN
    takes the config's ``loss_bbox`` beta."""
    got = _kwargs(Config(path).model, compat)
    assert got == _kwargs(JConfig(path).model, jcompat)
    rpn, head = got
    head_cfg = Config(path).model["bbox_head"]
    assert not any("loss" in k for k in head)
    assert set(head) <= {"type", "num_classes", "in_channels",
                         "fc_out_channels", "num_shared_fcs", "score_thresh",
                         "ratio_thr", "pos_weight", "assigner", "sampler",
                         "bbox_coder", "bbox_roi_extractor"}
    if "fix_loss" in head_cfg:
        assert head_cfg["fix_loss"]["beta"] == pytest.approx(1 / 3)
        assert head_cfg["ratio_loss"]["loss_weight"] == 16.0
    beta = (Config(path).model["rpn"].get("loss_bbox") or {}).get("beta")
    assert rpn.get("smooth_l1_beta") == beta


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_builds_at_full_width(path):
    """ResNet-50 / -101, FPN-256 (``on_input`` extra convs where the
    config asks), the 3-anchor hbb RPN, and the head with the config's
    classes, 1024-wide FCs over 256 x 7 x 7, its sampler, assigner,
    coder stds and extractor strides."""
    m = Config(path).model
    with torch.device("meta"):
        model = reg.build_from_cfg(m, reg.MODELS)
    assert type(model).__name__ == "GlidingVertex"
    assert sum(model.backbone.layers) == BLOCKS[m["backbone"]["type"]]
    assert model.backbone.frozen_stages == 1
    assert model.neck.add_extra_convs == (m["neck"].get("add_extra_convs")
                                          or None)
    assert isinstance(model.rpn, GlidingRPNHead)
    assert model.rpn.num_anchors == 3 and model.rpn.rpn_conv.in_channels == 256
    h = model.bbox_head
    hc = m["bbox_head"]
    assert isinstance(h, GlidingHead)
    assert h.num_classes == hc["num_classes"]
    assert h.fc_cls.out_features == hc["num_classes"] + 1
    assert h.shared_fc0.in_features == 256 * 7 * 7
    assert h.shared_fc1.out_features == 1024
    assert (h.fc_reg.out_features, h.fc_fix.out_features,
            h.fc_ratio.out_features) == (4, 4, 1)
    assert h.ratio_thr == hc.get("ratio_thr", 0.8)
    assert h.sampler.num == 512 and h.sampler.pos_fraction == 0.25
    assert h.sampler.add_gt_as_proposals
    asn = h.assigner
    assert (asn.pos_iou_thr, asn.neg_iou_thr, asn.min_pos_iou,
            asn.match_low_quality, asn.rotated) == (0.5, 0.5, 0.5, False,
                                                    False)
    assert h.coder.stds == (0.1, 0.1, 0.2, 0.2)
    assert h.extractor.featmap_strides == (4, 8, 16, 32)
    assert h.extractor.output_size == 7


def tiny_form(model):
    """A config's model section cut to a CPU test's size: Resnet18 with
    the config's freezing, a 32-wide FPN (the config's extra-conv mode),
    RPN (64 / 32 proposals) and head (64-wide FCs, 16 roi slots); the
    rest as the config has it."""
    m = copy.deepcopy(dict(model))
    m["backbone"] = dict(m["backbone"], type="Resnet18")
    m["backbone"].pop("pretrained", None)
    m["neck"] = dict(m["neck"], in_channels=[64, 128, 256, 512],
                     out_channels=32)
    m["rpn"] = dict(m["rpn"], in_channels=32, feat_channels=32, nms_pre=64,
                    nms_post=32, pre_nms_cap=128)
    head = dict(m["bbox_head"], in_channels=32, fc_out_channels=64)
    head["sampler"] = dict(head.get("sampler") or dict(
        type="RandomSampler", pos_fraction=0.25, add_gt_as_proposals=True),
        num=16)
    if head.get("bbox_roi_extractor"):
        head["bbox_roi_extractor"] = dict(head["bbox_roi_extractor"],
                                          out_channels=32)
    m["bbox_head"] = head
    return m


_JAX_PREDICT = {}


def _jax_predict(model, images):
    key = json.dumps(model, sort_keys=True, default=str)
    if key not in _JAX_PREDICT:
        jm = jreg.build_from_cfg(model, jreg.MODELS)
        x = jnp.asarray(images)
        v = perturb(jax.jit(lambda i: jm.init(
            {"params": jax.random.PRNGKey(0)}, i))(x), seed=6)
        v["params"]["_rpn"]["rpn_cls"]["kernel"] *= 40.0
        out = jax.jit(lambda v, i: jm.apply(v, i, method=jm.predict))(v, x)
        _JAX_PREDICT[key] = v, jax.tree_util.tree_map(np.asarray, out)
    return _JAX_PREDICT[key]


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_tiny_form_predicts_like_jax(path):
    """The same valid proposals, quads to 1e-3 px, scores to 5e-5 (as
    ``test_torch_gliding_networks.py``). The six configs give two tiny
    forms, each jitted once."""
    model = tiny_form(Config(path).model)
    rng = np.random.RandomState(12)
    tiles = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    images = normalize(torch.from_numpy(tiles))
    variables, ref = _jax_predict(model, images.numpy())
    port = reg.build_from_cfg(model, reg.MODELS).eval()
    load_jax_variables(port, variables)
    got = port.predict(images)
    assert ref["valid"].sum() > 16
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               atol=5e-5)
    np.testing.assert_allclose(got["polys"].numpy(), ref["polys"], atol=1e-3)
