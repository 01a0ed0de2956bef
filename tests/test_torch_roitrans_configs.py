"""The 13 zoo configs of the RoI-Transformer / FasterRCNN-OBB slice in the
port against the JAX package: the 11 ``projects/roi_transformer/configs``
that do not name ConvNeXt and the 2 ``projects/faster_rcnn/configs``.
Each loads to the same tree, each legacy section folds to the same head
and RPN sections (``adapt_rpn_cfg`` / ``adapt_cascade_head``) and these
normalize to the same kwargs, each builds at full width with its values
in the modules (on the meta device), and each config's tiny form
(Resnet18, 32-wide FPN and heads, the config's anchors, coders, classes
and stages) predicts as the JAX one from the same weights. The ConvNeXt
config raises the ``KeyError`` it raises in JAX; the 6 Gliding Vertex
configs build (``tests/test_torch_gliding_configs.py``). CPU, f32."""

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
    roi_transformer  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.models.roi_heads.rbbox_head import \
    RoITransformerHead
from rs_detection_tpu_torch.models.roi_heads.rpn_head import RPNHead
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJECTS = os.path.join(REPO, "projects")
CONFIGS = sorted(
    p for p in glob.glob(os.path.join(PROJECTS, "roi_transformer", "configs",
                                      "*.py"))
    if "convnext" not in os.path.basename(p).lower()) + sorted(
    glob.glob(os.path.join(PROJECTS, "faster_rcnn", "configs", "*.py")))
IDS = [os.path.basename(p)[:-3] for p in CONFIGS]
GLIDING = sorted(glob.glob(os.path.join(PROJECTS, "gliding", "configs",
                                        "*.py")))
DEPTH = {"Resnet50": 50, "Resnet101": 101, "Resnet152": 152}
BLOCKS = {50: 16, 101: 33, 152: 50}
LEGACY = ("rpn_head", "bbox_roi_extractor", "rbbox_roi_extractor",
          "rbbox_head", "train_cfg", "test_cfg")


def test_the_slice_has_13_configs():
    assert len(CONFIGS) == 13 and len(GLIDING) == 6


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_loads_like_jax(path):
    assert Config(path).dump() == JConfig(path).dump()


def _sections(model, lib):
    """The (rpn, bbox_head) sections a network builds from ``model``,
    by ``lib``'s adapters (the port's ``compat`` or the JAX one)."""
    rpn = model.get("rpn") or lib.adapt_rpn_cfg(model.get("rpn_head"))
    head = model.get("bbox_head")
    if model.get("rbbox_head") is not None or \
            model.get("bbox_roi_extractor") is not None:
        head = lib.adapt_cascade_head(
            head, model.get("rbbox_head"), model.get("bbox_roi_extractor"),
            model.get("rbbox_roi_extractor"), model.get("train_cfg"))
    return rpn, head


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_sections_fold_and_normalize_like_jax(path):
    got = _sections(Config(path).model, compat)
    ref = _sections(JConfig(path).model, jcompat)
    assert got == ref
    for sec in got:
        assert dict(compat.normalize_cfg(sec, reg.HEADS)) == dict(
            jcompat.normalize_cfg(sec, jreg.HEADS))


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_builds_at_full_width(path):
    """ResNet-50 / -101 / -152 at published widths, FPN-256 (the
    ``on_input`` extra convs where the config asks), the config's anchors
    in the hbb RPN, and the cascade with its classes, stages, stds,
    sampler and stage-2 loss: every value reaches the modules."""
    cfg = Config(path)
    m = cfg.model
    with torch.device("meta"):
        model = reg.build_from_cfg(m, reg.MODELS)
    assert type(model).__name__ == m["type"]
    depth = DEPTH[m["backbone"]["type"]]
    assert sum(model.backbone.layers) == BLOCKS[depth]
    assert model.backbone.frozen_stages == m["backbone"].get(
        "frozen_stages", -1)
    assert model.neck.in_channels == (256, 512, 1024, 2048)
    extra = m["neck"].get("add_extra_convs") or None
    assert model.neck.add_extra_convs == extra
    assert ("extra_conv_0" in dict(model.neck.named_modules())) == bool(extra)
    rpn, head = _sections(JConfig(path).model, jcompat)
    assert isinstance(model.rpn, RPNHead)
    ratios = (rpn.get("anchor_generator") or {}).get("ratios", [0.5, 1, 2])
    assert model.rpn.num_anchors == len(ratios)
    assert model.rpn.rpn_conv.in_channels == 256
    h = model.bbox_head
    assert isinstance(h, RoITransformerHead)
    stages = 1 if m["type"] == "FasterRCNNOBB" else head.get("num_stages", 2)
    assert h.num_stages == stages and (h.stage2 is None) == (stages == 1)
    assert h.num_classes == head["num_classes"]
    assert h.stage1.fc_cls.out_features == head["num_classes"] + 1
    assert h.stage1.fc0.in_features == 256 * 7 * 7
    assert h.reg_loss == head.get("reg_loss", "smooth_l1")
    assert h.sampler.num == head.get("sampler_num", 512)
    assert h.coder1.stds == tuple(head.get("stage1_stds",
                                           (0.1, 0.1, 0.2, 0.2, 0.1)))
    if stages == 2:
        assert h.coder2.stds == tuple(head.get(
            "stage2_stds", (0.05, 0.05, 0.1, 0.1, 0.05)))


def tiny_form(model):
    """A config's model section cut to a CPU test's size: Resnet18 with
    the config's freezing, a 32-wide FPN (the config's extra-conv mode),
    RPN and head, 64 / 32 proposals, 16 roi slots; anchors, coders,
    classes, stages and stage-2 loss as the config has them."""
    m = copy.deepcopy(dict(model))
    bb = dict(m["backbone"])
    bb.pop("depth", None)
    bb["type"] = "Resnet18"
    m["backbone"] = bb
    m["neck"] = dict(m["neck"], in_channels=[64, 128, 256, 512],
                     out_channels=32)
    rpn, head = _sections(model, jcompat)
    m["rpn"] = dict(rpn or dict(type="RPNHead"), in_channels=32,
                    feat_channels=32, nms_pre=64, nms_post=32,
                    pre_nms_cap=128)
    m["bbox_head"] = dict(head, in_channels=32, sampler_num=16)
    for k in LEGACY:
        m.pop(k, None)
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
    """The same valid proposals, polys to 1e-3 px, scores to 5e-5 (as
    ``test_torch_roitrans_networks.py``)."""
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


CONVNEXT = os.path.join(PROJECTS, "roi_transformer", "configs",
                        "RoITrans_convnext_xlarge_5e-5.py")


@pytest.mark.parametrize("path", [CONVNEXT],
                         ids=lambda p: os.path.basename(p)[:-3])
def test_unported_configs_raise_with_their_item(path):
    """The ConvNeXt config names ``Convnext_xlarge``, which neither
    package registers (JAX has ``convnext_xlarge``): it raises the same
    ``KeyError`` in both, never builds something else (ROADMAP, Queue 3;
    item 12 ported ConvNeXt). The Gliding Vertex configs build
    (``tests/test_torch_gliding_configs.py``)."""
    with pytest.raises(KeyError, match="'Convnext_xlarge' is not "
                       "registered in registry 'backbones'"):
        jax.eval_shape(lambda: jreg.build_from_cfg(
            JConfig(path).model, jreg.MODELS).init(
                jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    with torch.device("meta"), pytest.raises(
            KeyError, match="'Convnext_xlarge' is not registered in "
            "registry 'backbones'"):
        reg.build_from_cfg(Config(path).model, reg.MODELS)
