"""The 13 ``projects/oriented_rcnn/configs/*.py`` (ResNet-50 / -101
Oriented R-CNN, trained by SGD) in the port against the JAX package:
each loads to the same tree, each model section normalizes to the same
kwargs, each builds at full width with its values in the modules (on the
meta device), and each config's tiny form (Resnet18, 32-wide FPN and
heads, the config's anchors, coders, head type and classes) predicts as
the JAX one from the same weights. As in JAX, a head's ``loss_cls``
section (seesaw, group softmax, BCE, EQLv2) is dropped by
``normalize_cfg``; only ``OrientedEQLv2Head`` carries a loss state. CPU,
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
from rs_detection_tpu.models.networks.compat import \
    normalize_cfg as jnormalize_cfg
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.config.config import Config
from rs_detection_tpu_torch.flagship import normalize
from rs_detection_tpu_torch.models.backbones.resnet import ResNet
from rs_detection_tpu_torch.models.networks.compat import normalize_cfg
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORCNN = sorted(glob.glob(os.path.join(REPO, "projects", "oriented_rcnn",
                                      "configs", "*.py")))
ORCNN_IDS = [os.path.basename(p)[:-3] for p in ORCNN]
SECTIONS = [("backbone", "BACKBONES"), ("neck", "NECKS"), ("rpn", "HEADS"),
            ("bbox_head", "HEADS")]
DEPTH = {"Resnet50": 50, "Resnet101": 101}


def test_the_oriented_rcnn_project_has_13_configs():
    assert len(ORCNN) == 13


@pytest.mark.parametrize("path", ORCNN, ids=ORCNN_IDS)
def test_orcnn_config_loads_like_jax(path):
    assert Config(path).dump() == JConfig(path).dump()


@pytest.mark.parametrize("section,registry", SECTIONS,
                         ids=[s for s, _ in SECTIONS])
@pytest.mark.parametrize("path", ORCNN, ids=ORCNN_IDS)
def test_orcnn_sections_normalize_like_jax(path, section, registry):
    got = normalize_cfg(Config(path).model[section], getattr(reg, registry))
    ref = jnormalize_cfg(JConfig(path).model[section],
                         getattr(jreg, registry))
    assert dict(got) == dict(ref)


@pytest.mark.parametrize("path", ORCNN, ids=ORCNN_IDS)
def test_orcnn_config_builds_at_full_width(path):
    """ResNet-50 / -101 at published widths, FPN-256 on (256, 512, 1024,
    2048), the config's anchors, and its head: every value reaches the
    modules; the EQLv2 head has its state, the others none."""
    cfg = Config(path)
    with torch.device("meta"):
        model = reg.build_from_cfg(cfg.model, reg.MODELS)
    bb = cfg.model.backbone
    assert isinstance(model.backbone, ResNet)
    depth = bb.get("depth") or DEPTH[bb["type"]]
    assert len(model.backbone.layers) == 4 and sum(
        model.backbone.layers) == {50: 16, 101: 33}[depth]
    assert model.backbone.frozen_stages == bb.get("frozen_stages", -1)
    assert model.neck.in_channels == (256, 512, 1024, 2048)
    ratios = cfg.model.rpn["anchor_generator"]["ratios"]
    assert model.rpn.num_anchors == len(ratios)
    head = cfg.model.bbox_head
    assert type(model.bbox_head).__name__ == head["type"]
    assert model.bbox_head.num_classes == head["num_classes"]
    state = [k for k in model.state_dict() if ".efl." in k]
    want = ["bbox_head.efl.neg_grad", "bbox_head.efl.pos_grad"] \
        if head["type"] == "OrientedEQLv2Head" else []
    assert sorted(state) == want


def tiny_form(model):
    """A config's model section cut to a CPU test's size: Resnet18 with
    the config's freezing, a 32-wide FPN, RPN and head (64-wide FCs),
    fewer proposals; anchors, coders, assigners, samplers, the head's type
    and classes as the config has them."""
    m = copy.deepcopy(dict(model))
    bb = dict(m["backbone"])
    bb.pop("depth", None)
    bb["type"] = "Resnet18"
    m["backbone"] = bb
    m["neck"] = dict(m["neck"], in_channels=[64, 128, 256, 512],
                     out_channels=32)
    m["rpn"] = dict(m["rpn"], in_channels=32, feat_channels=32, nms_pre=64,
                    nms_post=32, pre_nms_cap=128)
    head = dict(m["bbox_head"], in_channels=32, fc_out_channels=64)
    head["bbox_roi_extractor"] = dict(head.get("bbox_roi_extractor") or {},
                                      out_channels=32)
    m["bbox_head"] = head
    return m


_JAX_PREDICT = {}


def _jax_predict(model, images):
    """The JAX model's perturbed variables and its predict of ``images``,
    once per distinct normalized model."""
    key = json.dumps({s: jnormalize_cfg(model[s], getattr(jreg, r))
                      for s, r in SECTIONS}, sort_keys=True, default=str)
    if key not in _JAX_PREDICT:
        jm = jreg.build_from_cfg(model, jreg.MODELS)
        x = jnp.asarray(images)
        v = perturb(jax.jit(lambda i: jm.init(
            {"params": jax.random.PRNGKey(0)}, i))(x), seed=6)
        out = jax.jit(lambda v, i: jm.apply(v, i, method=jm.predict))(v, x)
        _JAX_PREDICT[key] = v, jax.tree_util.tree_map(np.asarray, out)
    return _JAX_PREDICT[key]


@pytest.mark.parametrize("path", ORCNN, ids=ORCNN_IDS)
def test_orcnn_tiny_form_predicts_like_jax(path):
    """The same valid proposals, polys to 1e-3 px (as
    ``test_torch_port_config.py:test_tiny_from_config_predicts_like_jax``)
    and scores to 1e-5 (f32 through ResNet18's 8 blocks and perturbed
    norms; measured 2.4e-6, against 2e-6 there for the tiny VAN)."""
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
                               atol=1e-5)
    np.testing.assert_allclose(got["polys"].numpy(), ref["polys"],
                               atol=1e-3)


def test_r50_config_refuses_random_init_unless_allowed(tmp_path,
                                                      monkeypatch):
    """``orcnn_r50_fpn_1x_dota.py`` says ``pretrained=True``: the runner
    builds ResNet-50 Oriented R-CNN with SGD and refuses to train random
    weights unless the config sets ``allow_random_init``."""
    monkeypatch.delenv("RS_ALLOW_RANDOM_INIT", raising=False)
    path = os.path.join(REPO, "projects", "oriented_rcnn", "configs",
                        "orcnn_r50_fpn_1x_dota.py")
    for allow in (False, True):
        cfg = get_cfg()
        cfg.clear()
        cfg.update(copy.deepcopy(Config(path).dump()))
        cfg.update(dataset=None, allow_random_init=allow,
                   work_dir=str(tmp_path / f"w{allow}"))
        if not allow:
            with pytest.raises(RuntimeError, match="allow_random_init"):
                Runner(device="cpu")
            continue
        runner = Runner(device="cpu")
        assert isinstance(runner.model.backbone, ResNet)
        assert type(runner.optimizer).__name__ == "SGD"
        group = runner.optimizer.param_groups[0]
        assert (group["momentum"], group["weight_decay"]) == (0.9, 1e-4)
        assert runner.optimizer.max_norm == 35
