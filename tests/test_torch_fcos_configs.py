"""The 4 FCOS zoo configs (``configs/fcos`` and ``projects/fcos/configs``)
in the port against the JAX package: each loads to the same tree, its
head section (``roi_heads`` in three, ``bbox_head`` in
``fcos_r50_fpn_1x_dota.py``) normalizes to the same kwargs through
``compat.adapt_single_stage_head``'s generic path, and each builds at
full width on the meta device with the JAX network's parameter count and
the values the JAX head receives. CPU."""

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
from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.models.roi_heads.fcos_head import FCOSHead
from rs_detection_tpu_torch.utils import registry as reg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(
    glob.glob(os.path.join(REPO, "configs", "fcos", "*.py"))
    + glob.glob(os.path.join(REPO, "projects", "fcos", "configs", "*.py")))
IDS = [os.path.relpath(p, REPO).replace("/", ":")[:-3] for p in CONFIGS]
HEAD_FIELDS = ("num_classes", "strides", "regress_ranges", "center_sampling",
               "center_sample_radius", "norm_on_bbox", "scale_theta",
               "focal_gamma", "focal_alpha", "nms_pre", "score_thr",
               "nms_iou_thr", "max_per_img", "centerness_factor")


def _section(model):
    return model.get("roi_heads") or model.get("bbox_head")


def test_the_family_has_4_configs():
    assert len(CONFIGS) == 4


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_loads_like_jax(path):
    assert Config(path).dump() == JConfig(path).dump()


def _head_kwargs(model, lib):
    r = reg if lib is compat else jreg
    return json.loads(json.dumps(lib.normalize_cfg(
        lib.adapt_single_stage_head(_section(model)), r.HEADS)))


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_head_section_normalizes_like_jax(path):
    """The generic path: the same section out of
    ``adapt_single_stage_head`` and the same kwargs out of
    ``normalize_cfg`` as in JAX."""
    sec = _section(Config(path).model)
    assert compat.adapt_single_stage_head(sec) == \
        jcompat.adapt_single_stage_head(_section(JConfig(path).model))
    assert _head_kwargs(Config(path).model, compat) == _head_kwargs(
        JConfig(path).model, jcompat)


def test_pinned_values_of_the_head_sections():
    """``configs/fcos/fcos_obb_r50_fpn_1x_dota.py``'s ``roi_heads``: the
    focal section's gamma 2.0 and alpha 0.25, the ``test_cfg``'s
    centerness factor 0.5, 1,000 candidates a level, the 0.05 threshold,
    ``obb_nms``'s 0.1 and 2,000 detections; the loss sections (poly-IoU,
    the centerness BCE) dropped. ``fcos_r50_fpn_1x_dota.py``'s
    ``bbox_head`` keeps 16 classes and 256 channels and nothing else."""
    kw = _head_kwargs(Config(os.path.join(
        REPO, "configs", "fcos", "fcos_obb_r50_fpn_1x_dota.py")).model,
        compat)
    assert {k: kw[k] for k in (
        "focal_gamma", "focal_alpha", "centerness_factor", "nms_pre",
        "score_thr", "nms_iou_thr", "max_per_img", "num_classes")} == dict(
        focal_gamma=2.0, focal_alpha=0.25, centerness_factor=0.5,
        nms_pre=1000, score_thr=0.05, nms_iou_thr=0.1, max_per_img=2000,
        num_classes=15)
    assert not any(k.startswith("loss") for k in kw)
    kw = _head_kwargs(Config(os.path.join(
        REPO, "projects", "fcos", "configs", "fcos_r50_fpn_1x_dota.py")).model,
        compat)
    assert kw == dict(type="FCOSHead", num_classes=16, in_channels=256)


_JAX_COUNTS = {}


def _jax_count(model):
    """The JAX network's variables (parameters and batch statistics) from
    ``jax.eval_shape`` of its init at 256^2, once a model section."""
    key = json.dumps(model, sort_keys=True, default=str)
    if key not in _JAX_COUNTS:
        jm = jreg.build_from_cfg(model, jreg.MODELS)
        v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 256, 256, 3))))
        _JAX_COUNTS[key] = sum(int(np.prod(a.shape))
                               for a in jax.tree_util.tree_leaves(v))
    return _JAX_COUNTS[key]


@pytest.mark.parametrize("path", CONFIGS, ids=IDS)
def test_config_builds_at_full_width(path):
    """ResNet-50, FPN-256 from the config's start level with its
    extra-conv mode, the FCOS head with every value the JAX head receives
    (four GroupNorm convs a tower, eps 1e-6); the parameters and the
    BatchNorms' running statistics count what the JAX network's
    variables count (32,200,923 from C3, 36,397,788 from C2 with 16
    classes)."""
    m = Config(path).model
    with torch.device("meta"):
        model = reg.build_from_cfg(m, reg.MODELS)
    assert type(model).__name__ == "FCOS"
    assert sum(model.backbone.layers) == 16
    assert model.neck.start_level == m["neck"].get("start_level", 0)
    assert model.neck.add_extra_convs == m["neck"]["add_extra_convs"]
    h = model.bbox_head
    assert isinstance(h, FCOSHead)
    jh = jreg.build_from_cfg(_head_kwargs(JConfig(path).model, jcompat),
                             jreg.HEADS)
    for f in HEAD_FIELDS:
        want, got = getattr(jh, f), getattr(h, f)
        if isinstance(want, (list, tuple)):
            np.testing.assert_allclose(np.asarray(got, np.float64),
                                       np.asarray(want, np.float64),
                                       err_msg=f)
        else:
            assert got == pytest.approx(want), (f, got, want)
    assert h.cls_gn_3.num_groups == 32 and h.cls_gn_3.eps == 1e-6
    assert h.cls_0.in_channels == 256 and h.conv_cls.out_channels == \
        h.num_classes
    count = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for n, b in model.named_buffers()
        if n.endswith(("running_mean", "running_var")))
    assert count == _jax_count(JConfig(path).model)
    assert count == (36397788 if h.num_classes == 16 else 32200923)
