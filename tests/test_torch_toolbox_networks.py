"""The mmdet-v1 config sections of the two-stage networks, in both
packages with the same weights: the JAX ``RCNN`` declares ``rpn_head``,
``bbox_roi_extractor``, ``rbbox_roi_extractor``, ``rbbox_head``,
``shared_head``, ``train_cfg`` and ``test_cfg`` on every network and
reads only some of them. A tiny ``OrientedRCNN`` given ``shared_head``
and the cascade's sections (all ignored), or ``rpn_head`` in place of
``rpn`` (read), builds the same tree and predicts as without them; a
tiny RoI-Transformer given ``shared_head`` predicts as without it;
Gliding Vertex ignores ``rpn_head``, as the JAX network does. The
registries equal JAX's name for name. CPU, f32; tolerances as
``tests/test_torch_port_config.py:test_tiny_from_config_predicts_like_jax``
(polys 1e-3 px, scores 2e-6) and, for the cascade, as
``tests/test_torch_roitrans_configs.py`` (scores 5e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.flagship import flagship_cfg, normalize
from rs_detection_tpu_torch.models.roi_heads.rpn_head import GlidingRPNHead
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_variables)
from test_torch_gliding_cuda import tiny_model as tiny_gliding
from test_torch_port_slice import perturb
from test_torch_roitrans_cuda import tiny_model as tiny_roitrans
from torch_one_thread import _one_thread  # noqa: F401

SHARED = dict(type="ResLayer", depth=50, stage=3, stride=2)
CASCADE = dict(bbox_roi_extractor=dict(type="SingleRoIExtractor"),
               rbbox_roi_extractor=dict(type="RboxSingleRoIExtractor"),
               rbbox_head=dict(type="SharedFCBBoxHeadRbbox"),
               train_cfg=dict(rpn=dict(), rcnn=dict()),
               test_cfg=dict(rcnn=dict(score_thr=0.05)))


def _orcnn(case):
    cfg = flagship_cfg(tiny=True)
    if case == "shared_head":
        cfg["shared_head"] = dict(SHARED)
    elif case == "cascade_sections":
        cfg.update(CASCADE)
    elif case == "rpn_head":
        cfg["rpn_head"] = cfg.pop("rpn")
    return cfg


def _shapes(tree):
    """The port's state-dict names and shapes of a JAX tree (of arrays or
    of ``jax.eval_shape``'s shapes)."""
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype), tree)
    return {k: tuple(v.shape) for k, v in jax_to_state_dict(zeros).items()}


def _predict_pair(cfg, img, seed, spread_rpn=False):
    """The JAX model's variables (perturbed) and jitted ``predict`` of
    seeded tiles: (variables, images, predict)."""
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    x = jnp.zeros((1, img, img, 3), jnp.float32)
    v = perturb(jax.jit(lambda i: jm.init(
        {"params": jax.random.PRNGKey(0)}, i))(x), seed=seed)
    if spread_rpn:
        v["params"]["_rpn"]["rpn_cls"]["kernel"] *= 40.0
    tiles = np.random.RandomState(12).randint(0, 256, (2, img, img, 3))
    images = normalize(torch.from_numpy(tiles.astype(np.uint8)))
    ref = jax.jit(lambda v, i: jm.apply(v, i, method=jm.predict))(
        v, jnp.asarray(images.numpy()))
    return v, images, jax.tree_util.tree_map(np.asarray, ref)


def _assert_predicts(port, images, ref, score_atol=2e-6):
    got = port.eval().predict(images)
    assert ref["valid"].sum() > 8
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               atol=score_atol)
    np.testing.assert_allclose(got["polys"].numpy(), ref["polys"],
                               atol=1e-3)


@pytest.fixture(scope="module")
def orcnn_ref():
    return _predict_pair(_orcnn("plain"), 128, 5)


@pytest.mark.parametrize("case", ["shared_head", "cascade_sections",
                                  "rpn_head"])
def test_oriented_rcnn_takes_the_legacy_sections_like_jax(orcnn_ref, case):
    """Both packages build the network; the JAX tree has the plain
    network's shapes (nothing read but ``rpn_head``, which builds the same
    RPN), and the port, given that tree, predicts as the plain JAX
    network does."""
    v, images, ref = orcnn_ref
    cfg = _orcnn(case)
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    tree = jax.eval_shape(lambda i: jm.init(
        {"params": jax.random.PRNGKey(0)}, i),
        jnp.zeros((1, 128, 128, 3), jnp.float32))
    assert _shapes(tree) == _shapes(v)
    port = load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v)
    _assert_predicts(port, images, ref)


def test_roi_transformer_takes_shared_head_like_jax():
    """The tiny RoI-Transformer with ``shared_head`` (ignored by both
    packages) predicts with the JAX network's weights as the JAX network
    without it; the cascade's own legacy sections keep their tests in
    ``tests/test_torch_roitrans_configs.py``."""
    v, images, ref = _predict_pair(tiny_roitrans("roitrans"), 64, 7,
                                   spread_rpn=True)
    cfg = dict(tiny_roitrans("roitrans"), shared_head=dict(SHARED))
    jreg.build_from_cfg(cfg, jreg.MODELS)
    port = load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v)
    _assert_predicts(port, images, ref, score_atol=5e-5)


def test_gliding_vertex_ignores_rpn_head_like_jax():
    """The JAX network builds its RPN from ``rpn`` alone: with ``rpn``
    missing and an ``rpn_head`` section it takes the default
    ``GlidingRPNHead`` (256 channels), in both packages."""
    cfg = tiny_gliding()
    cfg.pop("rpn")
    cfg["neck"]["out_channels"] = 256
    cfg["bbox_head"]["in_channels"] = 256
    cfg["rpn_head"] = dict(type="RPNHead", in_channels=256, feat_channels=8)
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    tree = jax.eval_shape(lambda i: jm.init(
        {"params": jax.random.PRNGKey(0)}, i),
        jnp.zeros((1, 64, 64, 3), jnp.float32))
    port = reg.build_from_cfg(cfg, reg.MODELS)
    assert isinstance(port.rpn, GlidingRPNHead)
    rpn = {k: s for k, s in _shapes(tree).items() if k.startswith("rpn.")}
    assert rpn and rpn == {k: tuple(p.shape)
                           for k, p in port.state_dict().items()
                           if k.startswith("rpn.")}


def test_the_registries_equal_jax_by_name():
    jnames = {k for k, v in vars(jreg).items()
              if isinstance(v, jreg.Registry)}
    names = {k for k, v in vars(reg).items() if isinstance(v, reg.Registry)}
    assert names == jnames and {"BRICKS", "SHARED_HEADS"} <= names
    assert "DCNPooling" in reg.BRICKS and "DCNPooling" in jreg.BRICKS
