"""RetinaNet in the port against the JAX package, CPU, f32: a tiny
``RetinaNet`` in both head forms (the modern ``bbox_head`` section and
the legacy creator-style ``rpn_net`` section of ``projects/retinanet``,
folded by ``compat.adapt_legacy_retina``) built by each framework's
registry from one config, the JAX init (perturbed) carried across by
``load_jax_variables``: the head's dense outputs and the training
losses, and the modern form's ``predict`` (the classifier spread so
that the random head detects); a saved JAX tree loading through ``jax_weights``; and the
optimizer links against optax step by step: ``GradMutilpySGD`` with its
multipliers, and ``YangXuePrameterGroupsGenerator`` (the conv biases'
doubled gradients and decay correction inside the global-norm clip, the
frozen stem) around it."""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.models import param_generators as jpg
from rs_detection_tpu.optims import optimizer as joptim
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.flagship import make_targets, normalize
from rs_detection_tpu_torch.models import param_generators as pg
from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.models.roi_heads.retina_head import RetinaHead
from rs_detection_tpu_torch.optims.optimizer import GradMutilpySGD
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (load_jax_checkpoint,
                                                      load_jax_variables)
from test_torch_port_slice import perturb

IMG = 128
NECK = dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=32,
            start_level=1, num_outs=5, add_extra_convs="on_output",
            relu_before_extra_convs=True)


def legacy_head():
    """``retinanet_r50v1d_fpn_dota.py``'s ``rpn_net`` at 32 channels, 2
    classes, two angles and two stacked convs (18 anchors a position)."""
    return dict(type="RetinaHead", n_class=2, mode="R", in_channels=32,
                stacked_convs=2, max_dets=10000, nms_iou_threshold=0.3,
                roi_beta=1 / 9, score_threshold=0.05, loc_loss_weight=0.2,
                cls_loss_weight=1.0,
                anchor_generator=dict(
                    type="AnchorGeneratorRotated", angles=[-90, -45],
                    base_sizes=[32, 64, 128, 256, 512], mode="H",
                    ratios=[1, 0.5, 2.0],
                    scales=[1, 1.2599210498948732, 1.5874010519681994],
                    strides=[8, 16, 32, 64, 128]))


def tiny_retina(form):
    """A tiny RetinaNet: ResNet-18 with batch statistics, a 32-wide FPN
    from C3 with ``on_output`` extra convs, and the head in ``form``
    ("modern": ``retinanet_r50_fpn_1x_dota.py``'s section at 32 channels,
    3 classes, 32 candidates a level; "legacy": ``legacy_head()``)."""
    m = dict(type="RetinaNet", backbone=dict(type="ResNet", depth=18,
                                             norm_eval=False),
             neck=dict(NECK))
    if form == "legacy":
        m["rpn_net"] = legacy_head()
    else:
        m["bbox_head"] = dict(type="RetinaHead", num_classes=3,
                              in_channels=32, feat_channels=32,
                              stacked_convs=2, nms_pre=32, max_per_img=64)
    return m


def _data():
    """Two 128^2 tiles and 6 seeded boxes each (the last slot of the
    second image padded), labels 1-2. The seed is one whose boxes have no
    near-tie in either head form's assignment (``assignment_margin``)."""
    g = torch.Generator().manual_seed(7)
    tiles = torch.randint(0, 256, (2, IMG, IMG, 3), generator=g,
                          dtype=torch.uint8)
    t = make_targets(2, IMG, 6, g)
    t["gt_mask"][1, 5] = False
    t["labels"] = t["labels"].clamp(max=2)
    return normalize(tiles).numpy(), {k: v.numpy() for k, v in t.items()}


def assignment_margin(head, targets, sizes):
    """The smallest gap, over both images, between a box's best and
    second-best anchor IoU, and between any anchor's best IoU and the
    0.5 / 0.4 thresholds. The two frameworks' rotated IoUs agree to
    1e-5, not bit for bit (ROADMAP.md, Queue 3): where two anchors tie a
    box's best IoU (two squares that both contain a small box) the port
    keeps both and JAX the one its rounding puts 1 ulp higher. Loss
    parity is held where the margin exceeds that agreement."""
    from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated

    a = torch.cat([head.anchors(i, hw, "cpu") for i, hw in enumerate(sizes)])
    worst = 1.0
    for b in range(2):
        live = torch.from_numpy(targets["gt_mask"][b])
        iou = box_iou_rotated(a, torch.from_numpy(targets["rboxes"][b])[live])
        top2 = iou.topk(2, dim=0).values
        best = iou.amax(1)
        worst = min(worst, (top2[0] - top2[1]).min().item(),
                    (best - 0.5).abs().min().item(),
                    (best - 0.4).abs().min().item())
    return worst


def _spread(v):
    """The classifier spread (kernel x 60, biases N(0, 1)) so that the
    random head's scores pass the 0.05 threshold."""
    v = copy.deepcopy(v)
    cls = v["params"]["_bbox_head"]["retina_cls"]
    cls["kernel"] = cls["kernel"] * 60.0
    cls["bias"] = np.random.RandomState(8).randn(
        *cls["bias"].shape).astype(np.float32)
    return v


_NETS = {}


@pytest.fixture(scope="module", params=["modern", "legacy"])
def net(request):
    return _net(request.param)


def _net(form):
    """Per head form: the JAX network with perturbed variables and the
    port's with them, JAX's dense head outputs and losses, the variables
    with the classifier spread and the port's network with them."""
    if form in _NETS:
        return _NETS[form]
    images, targets = _data()
    cfg = tiny_retina(form)
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    x = jnp.asarray(images)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    v = perturb(jax.jit(lambda i: jm.init(jax.random.PRNGKey(0), i))(x),
                seed=7)

    def dense_and_loss(v, i):
        outs = jm.apply(v, i, method=lambda m, i: m._bbox_head(
            m.extract_feats(i)))
        loss, _ = jm.apply(v, i, jt, method=jm.loss,
                           mutable=["batch_stats"])
        return outs, loss

    outs, loss = jax.tree_util.tree_map(
        np.asarray, jax.jit(dense_and_loss)(v, x))
    spread = _spread(v)
    port = load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v)
    _NETS[form] = dict(
        form=form, cfg=cfg, jm=jm, images=images, targets=targets, v=v,
        outs=outs, loss=jax.tree_util.tree_map(float, loss), spread_v=spread,
        port=port, spread=load_jax_variables(
            reg.build_from_cfg(cfg, reg.MODELS), spread))
    return _NETS[form]


def test_head_outputs_match_jax(net):
    """Every level's cls logits and deltas (NHWC, A x C and A x 5) within
    1e-4 of each tensor's largest entry (f32 through ResNet-18 with
    perturbed norms, as ``tests/test_torch_s2anet_configs.py``)."""
    port = net["port"].eval()
    with torch.no_grad():
        got = port.bbox_head(port.extract_feats(
            torch.from_numpy(net["images"])))
    assert isinstance(port.bbox_head, RetinaHead)
    a = port.bbox_head.num_anchors
    assert a == (18 if net["form"] == "legacy" else 9)
    for g_out, r_out in zip(got, net["outs"]):
        assert len(g_out) == len(r_out) == 5
        for g_, r_ in zip(g_out, r_out):
            assert g_.shape == r_.shape and g_.shape[-1] in (a * 2, a * 5)
            np.testing.assert_allclose(g_.numpy(), r_,
                                       atol=1e-4 * np.abs(r_).max())


def test_predict_matches_jax():
    """The modern form's ``predict``: the same detection slots and labels,
    scores to 5e-5 and polygons to 1e-3 px
    (``tests/test_torch_roitrans_networks.py``'s tolerances), with
    detections in both images. The legacy form's is held by the runner's
    test task (``tests/test_torch_retinanet_runner.py``): its 2,000
    candidates an image take the JAX NMS ~18 s an image on the CPU."""
    net = _net("modern")
    ref = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, i: net["jm"].apply(v, i, method=net["jm"].predict))(
        net["spread_v"], jnp.asarray(net["images"])))
    got = net["spread"].eval().predict(torch.from_numpy(net["images"]))
    assert ref["valid"].sum(1).min() > 2
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               atol=5e-5)
    np.testing.assert_allclose(got["polys"].numpy(), ref["polys"], atol=1e-3)


def test_loss_matches_jax(net):
    """The focal and smooth-L1 losses within 1e-5 relative (train-mode
    batch statistics in f32 on both sides), both above 0, on boxes with
    no assignment near-tie (``assignment_margin`` above 1e-4)."""
    sizes = [(IMG // s, IMG // s) for s in (8, 16, 32, 64, 128)]
    assert assignment_margin(net["port"].bbox_head, net["targets"],
                             sizes) > 1e-4
    got = net["port"].train().loss(
        torch.from_numpy(net["images"]),
        {k: torch.from_numpy(x) for k, x in net["targets"].items()})
    ref = net["loss"]
    assert set(got) == set(ref) == {"loss_cls", "loss_bbox"}
    for k, r in ref.items():
        g = float(got[k].detach())
        assert r > 0 and abs(g - r) <= 1e-5 * r, (k, g, r)


def test_saved_jax_tree_loads(net, tmp_path):
    """A JAX RetinaNet tree pickled as numpy arrays loads through
    ``load_jax_checkpoint`` / ``load_jax_variables`` into every parameter
    of the port, the head's convs equal to the tree."""
    path = tmp_path / "retina.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, net["v"]), f)
    port = reg.build_from_cfg(net["cfg"], reg.MODELS)
    load_jax_variables(port, load_jax_checkpoint(str(path)))
    sd = port.state_dict()
    head = net["v"]["params"]["_bbox_head"]
    for name in ("cls_0", "cls_1", "reg_0", "reg_1", "retina_cls",
                 "retina_reg"):
        np.testing.assert_array_equal(
            sd[f"bbox_head.{name}.weight"].numpy(),
            head[name]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"bbox_head.{name}.bias"].numpy(),
                                      head[name]["bias"])


# ------------------------------------------------------ the optimizer links

class _Tree(nn.Module):
    """Parameters of every kind the masks tell apart: a ResNet stem
    (``Conv_0`` without bias, ``Norm_0``), a stage conv with a bias, a
    neck conv, a head linear and a norm."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(11)
        bb = nn.Module()
        bb.Conv_0 = nn.Conv2d(3, 4, 3, bias=False)
        bb.Norm_0 = nn.GroupNorm(2, 4)
        bb.layer1_0 = nn.Conv2d(4, 6, 3)
        self.backbone = bb
        self.neck = nn.Conv2d(6, 5, 1)
        self.head = nn.Linear(5, 3)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))


def _jax_tree(module):
    """The flax form of ``_Tree``'s parameters (HWIO kernels, (in, out)
    dense kernels, ``scale``), top names as the module's."""
    tree = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        a = p.detach().numpy()
        if leaf == "weight" and a.ndim == 4:
            node["kernel"] = a.transpose(2, 3, 1, 0)
        elif leaf == "weight" and a.ndim == 2:
            node["kernel"] = a.T
        elif leaf == "weight":
            node["scale"] = a
        else:
            node[leaf] = a
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch_layout(tree, module):
    """``_jax_tree``'s inverse for comparing: {name: array}."""
    out = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node[part]
        a = np.asarray(node["bias"] if leaf == "bias" else
                       node.get("kernel", node.get("scale")))
        out[name] = a.transpose(3, 2, 0, 1) if a.ndim == 4 else (
            a.T if a.ndim == 2 else a)
    return out


@pytest.mark.parametrize("kind", ["multipliers", "yangxue"])
def test_optimizer_links_match_optax_step_by_step(kind):
    """Three steps from the same parameters and the same gradients (10x
    a random tree, so that the clip at 3.0 scales every step): optax's
    ``GradMutilpySGD`` (clip -> multipliers -> decay -> momentum SGD) and
    the port's, and with ``YangXuePrameterGroupsGenerator`` (conv biases'
    gradients x 2, their decay corrected to 0, the ``backbone.C1`` stem
    frozen) around both; every parameter within 1e-6 after each step. The
    stem does not move, the head's linear bias is not a conv bias."""
    model = _Tree()
    named = list(model.named_parameters())
    mult = {"neck": 0.5} if kind == "multipliers" else None
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-2,
              grad_clip=dict(max_norm=3.0))
    tx = joptim.GradMutilpySGD(multipliers=mult, **kw)
    opt = GradMutilpySGD(named, multipliers=mult, **kw)
    if kind == "yangxue":
        gen = dict(conv_bias_grad_muyilpy=2.0, conv_bias_weight_decay=0.0,
                   freeze_prefix=["backbone.C1"])
        tx = jpg.YangXuePrameterGroupsGenerator(**gen)(
            tx, base_weight_decay=1e-2)
        pg.YangXuePrameterGroupsGenerator(**gen)(opt, base_weight_decay=1e-2)
        assert len(opt.frozen) == 3 and len(opt.grad_links) == 2
    params = _jax_tree(model)
    state = tx.init(params)
    start = {n: p.detach().clone() for n, p in named}
    rng = np.random.RandomState(3)
    for _ in range(3):
        for _, p in named:
            p.grad = torch.from_numpy(
                (10 * rng.randn(*p.shape)).astype(np.float32))
        grads = jax.tree_util.tree_map(jnp.asarray, _grad_tree(model))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        opt.step()
        ref = _torch_layout(params, model)
        for n, p in named:
            np.testing.assert_allclose(p.detach().numpy(), ref[n], atol=1e-6,
                                       err_msg=n)
    moved = {n: float((p.detach() - start[n]).abs().max()) for n, p in named}
    if kind == "yangxue":
        assert moved["backbone.Conv_0.weight"] == 0.0
        assert moved["backbone.Norm_0.bias"] == 0.0
    assert moved["head.bias"] > 0 and moved["neck.bias"] > 0


def _grad_tree(module):
    """The port's gradients in ``_jax_tree``'s form."""
    saved = {n: p.data for n, p in module.named_parameters()}
    for _, p in module.named_parameters():
        p.data = p.grad
    tree = _jax_tree(module)
    for n, p in module.named_parameters():
        p.data = saved[n]
    return tree


def test_prefix_mask_raises_on_no_match_and_names_the_stem():
    """``backbone.C1`` is the stem (``Conv_k`` / ``Norm_k``), ``C3`` the
    ``layer2_*`` blocks; a prefix that matches nothing raises, as the JAX
    ``_prefix_mask`` does."""
    assert pg.expand_prefix("backbone.C1") == jpg._expand_prefix(
        "backbone.C1") == ["backbone.Conv_", "backbone.Norm_"]
    assert pg.expand_prefix("backbone.C3") == jpg._expand_prefix(
        "backbone.C3")
    named = list(_Tree().named_parameters())
    assert len(pg.prefix_params(named, ["backbone.C1"])) == 3
    assert len(pg.conv_bias_params(named)) == 2
    with pytest.raises(ValueError, match="matched NO parameters"):
        pg.prefix_params(named, ["backbone.C5"])
