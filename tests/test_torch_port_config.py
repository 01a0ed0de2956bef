"""The port's config, registries and config-built model against the JAX
package: every ``configs/orcnn_van3_*.py`` loads to the same tree in
both, each section reaches its class with the kwargs the JAX
``normalize_cfg`` gives, the values reach the modules (the head
arguments that were once class constants), what the port cannot honour
raises, the tiny model built from a config predicts like the JAX one
with the same weights, and ``CosineAnnealingLR`` matches. CPU, f32."""

import glob
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
from rs_detection_tpu.optims.lr_scheduler import \
    CosineAnnealingLR as JCosineAnnealingLR
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config.config import Config
from rs_detection_tpu_torch.flagship import flagship_cfg, normalize
from rs_detection_tpu_torch.models.networks.compat import normalize_cfg
from rs_detection_tpu_torch.models.networks.rcnn import OrientedRCNN
from rs_detection_tpu_torch.optims.lr_scheduler import CosineAnnealingLR
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = sorted(glob.glob(os.path.join(REPO, "configs", "orcnn_van3_*.py")))
ZOO_IDS = [os.path.basename(p)[:-3] for p in ZOO]
SECTIONS = [("backbone", "BACKBONES"), ("neck", "NECKS"), ("rpn", "HEADS"),
            ("bbox_head", "HEADS")]


def test_zoo_has_the_flagship_configs():
    assert len(ZOO) == 5


@pytest.mark.parametrize("path", ZOO, ids=ZOO_IDS)
def test_zoo_config_loads_like_jax(path):
    assert Config(path).dump() == JConfig(path).dump()


@pytest.mark.parametrize("section,registry", SECTIONS,
                         ids=[s for s, _ in SECTIONS])
@pytest.mark.parametrize("path", ZOO, ids=ZOO_IDS)
def test_zoo_sections_normalize_like_jax(path, section, registry):
    """The kwargs each ported class is built with: ``normalize_cfg``
    folds the loss sections and drops undeclared keys as JAX does."""
    sec = Config(path).model[section]
    got = normalize_cfg(sec, getattr(reg, registry))
    ref = jnormalize_cfg(JConfig(path).model[section],
                         getattr(jreg, registry))
    assert dict(got) == dict(ref)


def _meta_model(model_cfg):
    """Build the port's model from a config section without allocating
    its weights."""
    with torch.device("meta"):
        return reg.build_from_cfg(model_cfg, reg.MODELS)


@pytest.mark.parametrize("path", ZOO, ids=ZOO_IDS)
def test_zoo_config_values_reach_the_modules(path):
    """Every value the JAX builder passes reaches the port's modules: the
    full-width VAN-b3 of each config, built on the meta device."""
    cfg = Config(path)
    model = _meta_model(cfg.model)
    rpn_cfg = normalize_cfg(cfg.model.rpn, reg.HEADS)
    head_cfg = normalize_cfg(cfg.model.bbox_head, reg.HEADS)
    assert isinstance(model, OrientedRCNN)
    assert model.backbone.depths == (3, 5, 27, 3)
    assert model.backbone.out_indices == (0, 1, 2, 3)
    assert model.neck.in_channels == (64, 128, 320, 512)
    rpn = model.rpn
    for key in ("nms_pre", "nms_post", "nms_thresh", "min_bbox_size",
                "pos_weight", "smooth_l1_beta", "loss_cls_weight",
                "loss_bbox_weight"):
        if key in rpn_cfg:
            assert getattr(rpn, key) == rpn_cfg[key], key
    assert rpn.smooth_l1_beta == pytest.approx(1.0 / 9.0)
    np.testing.assert_allclose(
        rpn.anchor_gen.ratios, rpn_cfg["anchor_generator"]["ratios"],
        rtol=1e-7)
    assert rpn.num_anchors == 7
    assert rpn.coder.stds == tuple(rpn_cfg["bbox_coder"]["target_stds"])
    assert rpn.assigner.pos_iou_thr == rpn_cfg["assigner"]["pos_iou_thr"]
    assert rpn.sampler.num == rpn_cfg["sampler"]["num"]
    head = model.bbox_head
    assert head.num_classes == head_cfg["num_classes"] == 10
    assert head.score_thresh == head_cfg["score_thresh"]
    assert head.coder.stds == tuple(head_cfg["bbox_coder"]["target_stds"])
    assert head.sampler.num == 512 and head.assigner.rotated
    assert head.extractor.extend_factor == (1.4, 1.2)
    assert head.fc_cls.out_features == 11
    assert head.shared_fc0.in_features == 256 * 7 * 7


def test_for_test_config_nms_reaches_the_head():
    """``nms_pre``/``nms_post`` 4000 of the test config are the head's,
    not the 2000 of a frozen class constant; ``score_thresh`` is stored
    (and, as in the JAX head, not applied)."""
    cfg = Config(os.path.join(REPO, "configs", "orcnn_van3_for_test_1.py"))
    model = _meta_model(cfg.model)
    assert model.rpn.nms_pre == 4000 and model.rpn.nms_post == 4000
    assert model.bbox_head.score_thresh == 0.001


def _tiny_cfg(**changes):
    cfg = flagship_cfg(tiny=True)
    for path, value in changes.items():
        node = cfg
        keys = path.split(".")
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = value
    return cfg


@pytest.mark.parametrize("changes,error", [
    ({"neck.add_extra_convs": "on_bogus"}, ValueError),
    ({"rpn.num_classes": 2}, NotImplementedError),
    ({"rpn.reg_dim": 5}, NotImplementedError),
    ({"compute_dtype": "int32"}, ValueError),
    ({"rpn.anchor_generator.octave_base_scale": 4}, TypeError),
    ({"bbox_head.bbox_roi_extractor.impl": "pallas"}, TypeError),
], ids=["fpn_extra_convs", "rpn_classes", "rpn_reg_dim",
        "int_dtype", "anchor_octaves", "extractor_impl"])
def test_unsupported_config_values_raise(changes, error):
    """A value the JAX package honours and the port cannot is refused,
    never dropped (and an extra-conv mode neither knows is refused)."""
    with pytest.raises(error):
        _meta_model(_tiny_cfg(**changes))


def test_fpn_start_level_matches_jax():
    """``start_level`` (honoured by both): the pyramid of inputs 1-3."""
    from rs_detection_tpu.models.necks.fpn import FPN as JFPN
    from test_torch_port_modules import _init, _j, _nhwc, _t

    dims = (8, 16, 24, 32)
    rng = np.random.RandomState(7)
    feats = _nhwc(rng, [(1, 16, 16, 8), (1, 8, 8, 16), (1, 4, 4, 24),
                        (1, 2, 2, 32)])
    kw = dict(in_channels=dims, out_channels=16, num_outs=4, start_level=1)
    jm = JFPN(**kw)
    v = _init(jm, 1, _j(feats))
    port = load_jax_variables(
        reg.build_from_cfg(dict(type="FPN", **kw), reg.NECKS).eval(), v)
    ref = jax.jit(jm.apply)(v, _j(feats))
    got = port(_t(feats))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=1e-4, atol=1e-4)


def test_tiny_from_config_predicts_like_jax():
    """One config dict, built by each framework's registry; JAX's init
    (perturbed) carried across by ``load_jax_variables``. Tolerances as
    ``test_torch_port_slice.py:test_tiny_predict_matches_jax``: f32 on
    both sides, atol 1e-3 px on polys and 2e-6 on scores."""
    cfg = flagship_cfg(tiny=True)
    jmodel = jreg.build_from_cfg(cfg, jreg.MODELS)
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    variables = perturb(jax.jit(lambda i: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, i))(x), seed=5)
    port = reg.build_from_cfg(cfg, reg.MODELS).eval()
    load_jax_variables(port, variables)
    rng = np.random.RandomState(12)
    tiles = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    images = normalize(torch.from_numpy(tiles))
    got = port.predict(images)
    ref = jax.jit(lambda v, i: jmodel.apply(v, i, method=jmodel.predict))(
        variables, jnp.asarray(images.numpy()))
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 32
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=2e-6)
    np.testing.assert_allclose(got["polys"].numpy(),
                               np.asarray(ref["polys"]), atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(max_steps=1, min_lr_ratio=0.01),
    dict(max_steps=9, min_lr_ratio=0.1, warmup="linear", warmup_iters=500,
         warmup_ratio=1.0 / 3),
    dict(min_lr=1e-6)],
    ids=["swa_fair1m_1_5", "warmup", "min_lr_ignored"])
def test_cosine_annealing_matches_jax(kw):
    """Over steps 0-599 at epochs 0 to 10 (past ``max_steps``); f32 on
    the JAX side (rtol 1e-6). ``min_lr`` is swallowed by both, leaving
    ``min_lr_ratio`` at 0."""
    got_s, ref_s = CosineAnnealingLR(**kw), JCosineAnnealingLR(**kw)
    steps = np.arange(600)
    for epoch in (0.0, 0.25, 1.0, 3.5, 8.0, 10.0):
        got = np.array([got_s(1e-4, int(i), epoch) for i in steps])
        ref = np.asarray(jax.vmap(lambda i: ref_s(1e-4, i, epoch))(
            jnp.asarray(steps)))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-16)
    if "min_lr" in kw:
        assert got_s.min_lr_ratio == 0.0
        assert got_s(1e-4, 0, 1.0) == pytest.approx(0.0, abs=1e-20)


def test_registries_name_the_ported_classes():
    from rs_detection_tpu_torch.models.networks import \
        single_stage  # noqa: F401  (registers S2ANet)

    for registry, names in ((reg.MODELS, ["OrientedRCNN", "S2ANet"]),
                            (reg.BACKBONES, ["VAN", "van_b0", "van_b3"]),
                            (reg.NECKS, ["FPN"]),
                            (reg.HEADS, ["OrientedRPNHead", "OrientedHead"]),
                            (reg.ROI_EXTRACTORS,
                             ["OrientedSingleRoIExtractor"])):
        for name in names:
            assert name in registry, (registry, name)
    # a detector neither package has
    assert "ReDet" not in jreg.MODELS
    with pytest.raises(KeyError, match="not registered"):
        reg.MODELS.get("ReDet")
