"""The 7 YOLO zoo configs (``projects/yolo/configs``) in the port against
the JAX package: each loads to the same tree, its model section
normalizes as in JAX, and it builds on the meta device with the JAX
network's parameter and statistics counts. Then the recipe's training
pieces as JAX has them: ``CosineAnnealingLRGroup`` (its rates, its
``TypeError``), ``YoloParameterGroupsGenerator`` built and applied to
nothing (quirk 2), the COCO dataset sections that reach no dataset
(quirk 4), and the model fields read by nothing (quirk 6). CPU."""

import glob
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.config.config import Config as JConfig
from rs_detection_tpu.data import yolo as _jyolo  # noqa: F401  (DATASETS)
from rs_detection_tpu.models import param_generators as jpg
from rs_detection_tpu.models.networks import compat as jcompat
from rs_detection_tpu.optims import lr_scheduler as jsched
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.config.config import Config
from rs_detection_tpu_torch.models.networks import compat
from rs_detection_tpu_torch.models.param_generators import (
    YoloParameterGroupsGenerator, takes_base_weight_decay, weight_decay_mask)
from rs_detection_tpu_torch.optims import lr_scheduler as sched
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.utils import registry as reg
from test_torch_fcos_networks import one_thread

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(p for p in glob.glob(os.path.join(
    REPO, "projects", "yolo", "configs", "*.py")) if not p.endswith("_base.py"))
COUNTS = {"YOLOv5S": (7235389, 19008), "YOLOv5M": (21190557, 36768),
          "YOLOv5L": (46563709, 60032), "YOLOv5X": (86749405, 88800),
          "YOLO": (7060084, 19008)}
ids = dict(ids=lambda p: os.path.basename(p)[:-3])
# quirk 3: (step, epoch) -> rate at base 0.01, max_steps 12, 22179
# warmup iterations from 0
POINTS = [((0, 0), 0.0), ((1000, 0), 4.509e-4), ((22179, 1), 9.864e-3),
          ((30000, 6), 6.000e-3), ((50000, 12), 2.000e-3)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def _counts(model):
    return (sum(p.numel() for p in model.parameters()),
            sum(b.numel() for n, b in model.named_buffers()
                if n.endswith(("running_mean", "running_var"))))


def test_there_are_seven():
    assert [os.path.basename(p)[:-3] for p in CONFIGS] == [
        "yolo_test", "yolov5l_coco_12epoch_ema", "yolov5m_coco_12epoch_ema",
        "yolov5s_coco128_300epoch_ema", "yolov5s_coco_12epoch_ema",
        "yolov5s_dota", "yolov5x_coco_12epoch_ema"]


@pytest.mark.parametrize("path", CONFIGS, **ids)
def test_config_loads_and_normalizes_like_jax(path):
    """The same tree, and the model section (and ``yolov5s_dota.py``'s
    head section) normalized alike: the variant names are constructor
    functions that pass through, ``YOLO`` keeps its declared fields."""
    cfg, jcfg = Config(path), JConfig(path)
    assert cfg.dump() == jcfg.dump()
    got = compat.normalize_cfg(cfg.model, reg.MODELS)
    want = jcompat.normalize_cfg(jcfg.model, jreg.MODELS)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    head = cfg.model.get("bbox_head")
    if head is not None:
        assert json.loads(json.dumps(compat.normalize_cfg(head, reg.HEADS))) \
            == json.loads(json.dumps(jcompat.normalize_cfg(
                jcfg.model["bbox_head"], jreg.HEADS)))


@pytest.mark.parametrize("path", CONFIGS, **ids)
def test_config_builds_with_the_jax_counts(path):
    """On the meta device, the parameters and BatchNorm statistics of the
    JAX network (``jax.eval_shape`` of its init at 64^2; the counts do
    not depend on the size): S 7,235,389 / 19,008, M 21,190,557 /
    36,768, L 46,563,709 / 60,032, X 86,749,405 / 88,800, the DOTA
    config's 15-class S 7,060,084; ``ema`` as the config sets it."""
    model_cfg = Config(path).model
    with torch.device("meta"):
        model = reg.build_from_cfg(model_cfg, reg.MODELS)
    assert _counts(model) == COUNTS[model_cfg["type"]]
    assert model.ema == bool(model_cfg.get("ema", False))
    assert jax_counts(model_cfg["type"], JConfig(path).model) == \
        _counts(model)


JAX_COUNTS = {}


def jax_counts(name, section):
    """(parameters, statistics) of the JAX network of ``section``, once a
    model type (the three YOLOv5S configs build one network)."""
    if name not in JAX_COUNTS:
        jm = jreg.build_from_cfg(section, jreg.MODELS)
        v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 64, 64, 3))))
        JAX_COUNTS[name] = tuple(
            sum(int(np.prod(a.shape)) for a in
                jax.tree_util.tree_leaves(v[c]))
            for c in ("params", "batch_stats"))
    return JAX_COUNTS[name]


def test_cosine_annealing_lr_group_as_jax():
    """Quirk 3: the parent's cosine by epoch over ``max_steps`` times the
    linear warmup, ``warmup_init_lr_pg`` and ``warmup_initial_momentum``
    recorded and used by nothing: the rates of JAX's at the five points
    (within 1e-9) and of the issue's reading (within 1e-6); without
    ``max_steps`` or ``max_epoch`` both raise ``TypeError``, with
    ``max_epoch`` both take it."""
    kw = dict(max_steps=12, min_lr_ratio=0.2, warmup="linear",
              warmup_iters=22179, warmup_ratio=0.0,
              warmup_init_lr_pg=[0.0, 0.0, 0.1], warmup_initial_momentum=0.8)
    got, want = sched.CosineAnnealingLRGroup(**kw), \
        jsched.CosineAnnealingLRGroup(**kw)
    for (step, epoch), rate in POINTS:
        g = got(0.01, step, epoch)
        assert abs(g - float(want(0.01, step, epoch))) <= 1e-9
        assert abs(g - rate) <= 1e-6, (step, epoch, g, rate)
    assert got.warmup_init_lr_pg == [0.0, 0.0, 0.1]
    assert got.warmup_initial_momentum == 0.8
    kw.pop("max_steps")
    for cls in (sched.CosineAnnealingLRGroup, jsched.CosineAnnealingLRGroup):
        with pytest.raises(TypeError, match="max_steps"):
            cls(**kw)
        assert cls(max_epoch=300, **kw).max_steps == 300


@pytest.mark.parametrize("name, decay", [("yolov5s_coco_12epoch_ema", 1e-4),
                                         ("yolov5s_dota", 5e-4)])
def test_the_generator_applies_nothing(name, decay, tmp_path):
    """Quirk 2: the runner builds ``YoloParameterGroupsGenerator`` and
    applies none of it, as the JAX runner's signature check skips it (it
    takes ``params``, not ``base_weight_decay``): every parameter keeps
    the SGD section's decay, the recipe's 5e-4 reaching none. The COCO
    recipes' SGD sections name no decay, so SGD's default 1e-4 (in both
    packages) applies to every parameter; ``yolov5s_dota.py`` puts 5e-4
    on SGD itself. The generator's mask is JAX's: decay on the conv
    weights, none on biases and norm scales."""
    path = os.path.join(REPO, "projects", "yolo", "configs", name + ".py")
    c = get_cfg()
    c.clear()
    c.update(Config(path).dump())
    c.update(dict(work_dir=str(tmp_path), dataset=None,
                  pretrained_weights=None, allow_random_init=True))
    runner = Runner(device="cpu")
    assert {g["weight_decay"] for g in runner.optimizer.param_groups} == \
        {decay}
    assert not runner.optimizer.grad_links and not runner.optimizer.frozen
    pg = Config(path).parameter_groups_generator
    if pg is None:
        return
    gen = reg.build_from_cfg(dict(pg), reg.MODELS)
    jgen = jreg.build_from_cfg(dict(pg), jreg.MODELS)
    assert isinstance(gen, YoloParameterGroupsGenerator)
    assert not takes_base_weight_decay(gen)
    assert "base_weight_decay" not in inspect.signature(jgen).parameters
    assert callable(jgen) and not hasattr(jgen, "decay_mask")
    mask = gen(runner.model.named_parameters())
    assert mask["weight_decay"] == jgen.weight_decay == 0.0005
    m = mask["decay_mask"]
    assert m["backbone.stem_conv.weight"] and m["bbox_head.out0.weight"]
    assert not m["backbone.stem_bn.weight"] and not m["bbox_head.out0.bias"]
    jm = jpg.weight_decay_mask(dict(
        _backbone=dict(stem_conv=dict(kernel=np.zeros((6, 6, 3, 32))),
                       stem_bn=dict(scale=np.zeros(32), bias=np.zeros(32)))))
    assert jm["_backbone"]["stem_conv"]["kernel"]
    assert not jm["_backbone"]["stem_bn"]["scale"]
    assert weight_decay_mask([("a.weight", torch.zeros(2, 2, 1, 1)),
                              ("a.bias", torch.zeros(2))]) == \
        {"a.weight": True, "a.bias": False}


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_coco_dataset_sections_reach_no_dataset(split):
    """Quirk 4: the COCO configs' ``YoloDataset`` sections give ``path`` /
    ``imgsz`` / ``augment``, which fall into ``**kw``; with no
    ``annotations_file`` (or ``dataset_dir``) both packages' classes
    raise the same ``TypeError`` on ``open(None)``."""
    path = os.path.join(REPO, "projects", "yolo", "configs",
                        "yolov5x_coco_12epoch_ema.py")
    sec = Config(path).dataset[split]
    assert "path" in sec and "annotations_file" not in sec
    for registry, s in ((reg.DATASETS, sec),
                        (jreg.DATASETS, JConfig(path).dataset[split])):
        with pytest.raises(TypeError, match="NoneType"):
            registry.get("YoloDataset")(**{k: v for k, v in dict(s).items()
                                            if k != "type"})


def test_unread_fields_change_nothing():
    """Quirk 6: ``cls_pw``, ``obj_pw``, ``fl_gamma``, ``ch``, ``imgsz``,
    ``is_coco`` and ``pretrained`` are taken and read by nothing: the
    same layers (a 3-channel stem whatever ``ch``), the same head gains
    and the same losses as without them; the flat gains reach the head."""
    base = dict(type="YOLO", nc=4, depth_multiple=0.33, width_multiple=0.125,
                boxlg=0.1, clslg=0.25, objlg=2.0, anchor_t=3.0)
    odd = dict(base, cls_pw=5.0, obj_pw=3.0, fl_gamma=2.0, ch=1, imgsz=320,
               is_coco=True, pretrained="none.pkl")
    torch.manual_seed(0)
    a = reg.build_from_cfg(base, reg.MODELS)
    b = reg.build_from_cfg(odd, reg.MODELS)
    b.load_state_dict(a.state_dict())
    assert a.backbone.stem_conv.in_channels == b.backbone.stem_conv.in_channels \
        == 3
    for h in (a.bbox_head, b.bbox_head):
        assert (h.box_w, h.cls_w, h.obj_w, h.anchor_t) == (0.1, 0.25, 2.0,
                                                           3.0)
    x = torch.rand(1, 64, 64, 3)
    t = dict(hboxes=torch.tensor([[[8.0, 8.0, 40.0, 30.0]]]),
             gt_mask=torch.ones(1, 1, dtype=torch.bool),
             labels=torch.tensor([[2]]))
    with torch.no_grad():
        la, lb = a.loss(x, t), b.loss(x, t)
    assert {k: float(v) for k, v in la.items()} == \
        {k: float(v) for k, v in lb.items()}
