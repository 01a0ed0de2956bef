"""The two SSD zoo configs (``projects/ssd/configs/ssd300_coco.py`` and
``ssd300_coco_test.py``) in the port against the JAX package: each loads
to the same tree, its ``SSDHead`` section adapts as the JAX
``_adapt_ssd`` folds it (on every key, also where a section lacks one),
and each builds at full width on the meta device with the JAX network's
parameter count, 39,202,226. The neck's constructor reads both schemas
as JAX's does. CPU."""

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
from rs_detection_tpu_torch.models.backbones.ssd_vgg import SSDVGG
from rs_detection_tpu_torch.models.necks.ssd_neck import SSDNeck
from rs_detection_tpu_torch.models.networks import compat
from rs_detection_tpu_torch.models.roi_heads.ssd_head import SSDHead
from rs_detection_tpu_torch.runner import runner  # noqa: F401  (registries)
from rs_detection_tpu_torch.utils import registry as reg
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD = sorted(glob.glob(os.path.join(REPO, "projects", "ssd", "configs",
                                    "*.py")))
HEAD_FIELDS = ("num_classes", "anchor_strides", "input_size",
               "target_means", "target_stds",
               "neg_pos_ratio", "nms_pre", "score_thr", "nms_iou_thr",
               "max_per_img")
ids = dict(ids=lambda p: os.path.basename(p)[:-3])


def test_there_are_two():
    assert [os.path.basename(p) for p in SSD] == ["ssd300_coco.py",
                                                  "ssd300_coco_test.py"]


@pytest.mark.parametrize("path", SSD, **ids)
def test_config_loads_like_jax(path):
    assert Config(path).dump() == JConfig(path).dump()


@pytest.mark.parametrize("path", SSD, **ids)
def test_head_section_adapts_like_jax(path):
    """The zoo's ``SSDHead`` section through ``adapt_single_stage_head``
    equals the JAX ``_adapt_ssd``: 81 classes with the background, the
    generator's strides, ratios, range and input size, the coder's
    stds, ``neg_pos_ratio`` 3, ``nms_pre`` 1000, ``score_thr`` 0.02,
    ``max_per_img`` 200, the NMS at 0.45; the rest of ``train_cfg`` (the
    assigner, ``smoothl1_beta``) dropped in both. It normalizes to the
    same kwargs."""
    sec, jsec = Config(path).model["roi_heads"], \
        JConfig(path).model["roi_heads"]
    got = compat.adapt_single_stage_head(sec)
    want = jcompat.adapt_single_stage_head(jsec)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    assert got["num_classes"] == 81 and got["neg_pos_ratio"] == 3
    assert (got["nms_pre"], got["score_thr"], got["max_per_img"],
            got["nms_iou_thr"]) == (1000, 0.02, 200, 0.45)
    assert "train_cfg" not in got and "assigner" not in got
    assert json.loads(json.dumps(compat.normalize_cfg(got, reg.HEADS))) == \
        json.loads(json.dumps(jcompat.normalize_cfg(want, jreg.HEADS)))


@pytest.mark.parametrize("sec", [
    dict(type="SSDHead"),
    dict(type="SSDHead", num_classes=20,
         bbox_coder=dict(target_means=[0.1] * 4, target_stds=[0.5] * 4),
         anchor_generator=dict(strides=[8, 16], ratios=[[2], [3]],
                               basesize_ratio_range=[0.2, 0.9],
                               input_size=512),
         train_cfg=dict(neg_pos_ratio=2, smoothl1_beta=0.5),
         test_cfg=dict(nms_pre=50, score_thr=0.1, max_per_img=10,
                       nms=dict(iou_threshold=0.3)))],
    ids=["bare", "every_key"])
def test_adapt_ssd_matches_jax_on_every_key(sec):
    """``adapt_ssd`` equals the JAX ``_adapt_ssd`` on a bare section (80
    classes and the defaults) and on one with every key it reads (the
    ``bbox_coder`` spelling of the coder)."""
    assert compat.adapt_ssd(dict(sec)) == jcompat._adapt_ssd(dict(sec))


@pytest.mark.parametrize("schema", [
    dict(), dict(level_paddings=[1, 1, 1, 1]),
    dict(extra_cfg=[(64, 128, 2, 1), (32, 64, 1, 0)])],
    ids=["zoo", "padded", "extra_cfg"])
def test_neck_constructor_reads_both_schemas(schema):
    """The registered ``SSDNeck`` builds the JAX constructor's extra
    pairs from the zoo's flat lists (reduce to ``max(out // 2, 128)``) or
    takes ``extra_cfg`` as given."""
    neck = reg.build_from_cfg(dict(type="SSDNeck", **schema), reg.NECKS)
    jneck = jreg.build_from_cfg(dict(type="SSDNeck", **schema), jreg.NECKS)
    assert isinstance(neck, SSDNeck)
    assert neck.extra_cfg == tuple(tuple(e) for e in jneck.extra_cfg)


@pytest.mark.parametrize("path", SSD, **ids)
def test_config_builds_at_full_width(path):
    """``SSD_VGG16`` (``pretrained`` dropped), the SSD neck and the head
    with every value the JAX head receives, 5 / 9 anchors a position;
    the parameters count what the JAX network's variables count,
    39,202,226."""
    m = Config(path).model
    with torch.device("meta"):
        model = reg.build_from_cfg(m, reg.MODELS)
    assert type(model).__name__ == "SingleStageDetector"
    assert isinstance(model.backbone, SSDVGG)
    assert isinstance(model.neck, SSDNeck)
    h = model.bbox_head
    assert isinstance(h, SSDHead)
    assert h.anchor_gen.num_base_anchors == [5, 9, 9, 9, 5, 5]
    jm = jreg.build_from_cfg(JConfig(path).model, jreg.MODELS)
    jh = jreg.build_from_cfg(jcompat.normalize_cfg(
        jcompat.adapt_single_stage_head(JConfig(path).model["roi_heads"]),
        jreg.HEADS), jreg.HEADS)
    got = dict(num_classes=h.num_classes,
               anchor_strides=h.anchor_gen.strides,
               input_size=h.anchor_gen.input_size,
               target_means=h.target_means, target_stds=h.target_stds,
               neg_pos_ratio=h.neg_pos_ratio, nms_pre=h.nms_pre,
               score_thr=h.score_thr, nms_iou_thr=h.nms_iou_thr,
               max_per_img=h.max_per_img)
    for f in HEAD_FIELDS:
        want = getattr(jh, f)
        if isinstance(want, (list, tuple)):
            np.testing.assert_allclose(np.asarray(got[f], np.float64),
                                       np.asarray(want, np.float64),
                                       rtol=1e-6, err_msg=f)
        else:
            assert got[f] == pytest.approx(want), (f, got[f], want)
    assert [len(r) for r in h.anchor_gen.ratios_per_level] == \
        [1 + 2 * len(r) for r in jh.anchor_ratios]
    count = sum(p.numel() for p in model.parameters())
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 300, 300, 3))))
    assert count == sum(int(np.prod(a.shape))
                        for a in jax.tree_util.tree_leaves(v)) == 39202226


def test_default_neck_below_272_makes_empty_levels():
    """The zoo's neck (paddings 1, 1, 0, 0) below 272^2: in JAX SSD at
    64^2 has the levels 8, 4, 2, 1, 0, 0 (a 3x3 conv without padding on
    a 1x1 map gives an empty one); torch's ``conv2d`` refuses that
    kernel, and the port's ``models/utils/modules.py:conv2d`` gives the
    empty map as XLA does, so its neck makes the same levels. With
    padding 1 on every extra level (the tests' tiny model) no level is
    empty."""
    m = JConfig(SSD[0]).model
    jm = jreg.build_from_cfg(m, jreg.MODELS)
    feats = jax.eval_shape(lambda: jm.apply(
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))),
        jnp.zeros((1, 64, 64, 3)), method=lambda mod, i: mod.extract_feats(
            i)))
    assert [f.shape[1] for f in feats] == [8, 4, 2, 1, 0, 0]
    neck = reg.build_from_cfg(dict(m["neck"]), reg.NECKS)
    with torch.no_grad():
        out = neck((torch.zeros(1, 8, 8, 512), torch.zeros(1, 4, 4, 1024)))
    assert [tuple(f.shape) for f in out] == [tuple(f.shape) for f in feats]
    padded = reg.build_from_cfg(dict(m["neck"], level_paddings=[1] * 4),
                                reg.NECKS)
    with torch.no_grad():
        out = padded((torch.zeros(1, 8, 8, 512), torch.zeros(1, 4, 4, 1024)))
    assert [f.shape[1] for f in out] == [8, 4, 2, 1, 1, 1]
