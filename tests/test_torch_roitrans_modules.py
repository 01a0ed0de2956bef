"""The modules of the RoI-Transformer / FasterRCNN-OBB slice against their
JAX twins on the CPU, f32, from the same numpy-seeded inputs (and, for
modules with weights, the JAX init perturbed and carried across by
``load_jax_variables``): the hbb and rotated box ops and coders, the IoU
calculators, the rotated assigner and sampler, FPN's extra-conv modes,
the horizontal RoIAlign and both extractors, the Gaussian losses (KFIoU
with its masked negatives), the hbb ``RPNHead`` and the
``RoITransformerHead``. Where a loss samples, both sides sample the first
candidates by index (``first_k_sample``): the two frameworks draw
different numbers from one seed."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.models.boxes import coder as jcoder
from rs_detection_tpu.models.boxes import iou_calculator as jiou
from rs_detection_tpu.models.boxes import sampler as jsampler
from rs_detection_tpu.models.boxes.assigner import \
    MaxIoUAssigner as JAssigner
from rs_detection_tpu.models.boxes.assigner import \
    MaxIoUAssignerRbbox as JAssignerRbbox
from rs_detection_tpu.models.necks.fpn import FPN as JFPN
from rs_detection_tpu.models.roi_extractors import \
    oriented_single_level as jext
from rs_detection_tpu.models.roi_heads.rbbox_head import \
    RoITransformerHead as JHead
from rs_detection_tpu.models.roi_heads.rpn_head import RPNHead as JRPN
from rs_detection_tpu.ops import box_ops as JB
from rs_detection_tpu.ops.roi_align import roi_align as jroi_align
from rs_detection_tpu_torch.models.boxes import coder as tcoder
from rs_detection_tpu_torch.models.boxes import iou_calculator as tiou
from rs_detection_tpu_torch.models.boxes.assigner import (
    MaxIoUAssigner, MaxIoUAssignerRbbox)
from rs_detection_tpu_torch.models.boxes.sampler import (
    RandomSampler, RandomSamplerRotated)
from rs_detection_tpu_torch.models.losses import poly_iou_loss as tloss
from rs_detection_tpu_torch.models.necks.fpn import FPN
from rs_detection_tpu_torch.models.roi_extractors import \
    oriented_single_level as text
from rs_detection_tpu_torch.models.roi_heads.rbbox_head import \
    RoITransformerHead
from rs_detection_tpu_torch.models.roi_heads.rpn_head import RPNHead
from rs_detection_tpu_torch.ops import box_ops as B
from rs_detection_tpu_torch.ops import roi_align as ra
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_variables)
from test_torch_port_modules import _init, _j, _nhwc, _t
from test_torch_roitrans_cuda import first_k_sample

jloss = importlib.import_module("rs_detection_tpu.models.losses.poly_iou_loss")

# f32 on both sides; elementwise box math agrees to a few ulps, sums and
# matmuls to ~1e-6 relative
RTOL, ATOL = 1e-5, 1e-4


def _first_k_jax(sampler, assigned, key):
    pos = assigned > 0
    pos = pos & (jnp.cumsum(pos) <= int(sampler.num * sampler.pos_fraction))
    neg = assigned == 0
    return pos, neg & (jnp.cumsum(neg) <= sampler.num - pos.sum())


@pytest.fixture
def first_k(monkeypatch):
    """Both frameworks' ``RandomSampler`` pick the first candidates."""
    monkeypatch.setattr(jsampler.RandomSampler, "sample", _first_k_jax)
    monkeypatch.setattr(RandomSampler, "sample", first_k_sample)


def _hbbs(rng, n, img=64.0, lead=()):
    xy = rng.uniform(-0.1, 1.0, lead + (n, 2)) * img
    wh = np.exp(rng.uniform(np.log(2), np.log(img), lead + (n, 2)))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _obbs(rng, n, img=64.0, lead=()):
    return np.concatenate([
        rng.uniform(0, img, lead + (n, 2)),
        np.exp(rng.uniform(np.log(3), np.log(img), lead + (n, 2))),
        rng.uniform(-np.pi, np.pi, lead + (n, 1))], -1).astype(np.float32)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach() if hasattr(
        got, "detach") else got), np.asarray(ref), rtol=rtol, atol=atol)


def test_box_conversions_match():
    rng = np.random.RandomState(0)
    hbb, obb = _hbbs(rng, 50), _obbs(rng, 50)
    _close(B.hbb2obb(torch.from_numpy(hbb)), JB.hbb2obb(jnp.asarray(hbb)))
    _close(B.obb2hbb(torch.from_numpy(obb)), JB.obb2hbb(jnp.asarray(obb)))
    _close(B.rotated_box_to_poly(torch.from_numpy(obb)),
           JB.rotated_box_to_poly(jnp.asarray(obb), best_begin=False))
    # a taller box turns by -pi/2
    assert B.hbb2obb(torch.tensor([[0.0, 0.0, 2.0, 8.0]]))[0, 4] == \
        -np.pi / 2


@pytest.mark.parametrize("max_shape", [None, (48, 40)],
                         ids=["unclipped", "clipped"])
def test_hbb_deltas_match(max_shape):
    """bbox2delta / delta2bbox with means and stds, K = 2 boxes per row,
    wh_ratio_clip biting on the large deltas, clipping to max_shape."""
    rng = np.random.RandomState(1)
    rois, gts = _hbbs(rng, 40), _hbbs(rng, 40)
    means, stds = (0.1, -0.1, 0.0, 0.2), (0.1, 0.1, 0.2, 0.2)
    _close(B.bbox2delta(torch.from_numpy(rois), torch.from_numpy(gts),
                        means, stds),
           JB.bbox2delta(jnp.asarray(rois), jnp.asarray(gts), means, stds))
    deltas = rng.randn(40, 8).astype(np.float32) * 3
    for clip in (16 / 1000, 0.5):
        _close(B.delta2bbox(torch.from_numpy(rois), torch.from_numpy(deltas),
                            means, stds, max_shape, clip),
               JB.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas), means,
                             stds, max_shape, clip))


def test_rotated_deltas_match():
    rng = np.random.RandomState(2)
    rois, gts = _obbs(rng, 60), _obbs(rng, 60)
    stds = (0.1, 0.1, 0.2, 0.2, 0.1)
    _close(B.bbox2delta_rotated(torch.from_numpy(rois), torch.from_numpy(gts),
                                stds=stds),
           JB.bbox2delta_rotated(jnp.asarray(rois), jnp.asarray(gts),
                                 stds=stds))
    deltas = rng.randn(60, 5).astype(np.float32) * 2
    _close(B.delta2bbox_rotated(torch.from_numpy(rois),
                                torch.from_numpy(deltas), stds=stds),
           JB.delta2bbox_rotated(jnp.asarray(rois), jnp.asarray(deltas),
                                 stds=stds))


@pytest.mark.parametrize("name", ["DeltaXYWHBBoxCoder",
                                  "GVDeltaXYWHBBoxCoder",
                                  "DeltaXYWHABBoxCoder"])
def test_coders_match(name):
    rng = np.random.RandomState(3)
    rot = name == "DeltaXYWHABBoxCoder"
    make = _obbs if rot else _hbbs
    d = 5 if rot else 4
    rois, gts = make(rng, 30, lead=(2,)), make(rng, 30, lead=(2,))
    kw = dict(target_means=(0.0,) * d,
              target_stds=(0.1, 0.1, 0.2, 0.2, 0.1)[:d])
    port = reg.BOXES.get(name)(**kw)
    jax_coder = getattr(jcoder, name)(**kw)
    _close(port.encode(torch.from_numpy(rois), torch.from_numpy(gts)),
           jax_coder.encode(jnp.asarray(rois), jnp.asarray(gts)))
    deltas = rng.randn(2, 30, d).astype(np.float32)
    shape = None if rot else (50, 60)
    _close(port.decode(torch.from_numpy(rois), torch.from_numpy(deltas),
                       shape),
           jax_coder.decode(jnp.asarray(rois), jnp.asarray(deltas), shape))
    assert type(port).__module__ == tcoder.__name__


@pytest.mark.parametrize("name", ["BboxOverlaps2D", "BboxOverlaps2D_v1",
                                  "BboxOverlaps2D_rotated",
                                  "BboxOverlaps2D_rotated_v1"])
@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_iou_calculators_match(name, mode):
    rng = np.random.RandomState(4)
    make = _obbs if "rotated" in name else _hbbs
    a, b = make(rng, 30), make(rng, 20)
    got = reg.BOXES.get(name)()(torch.from_numpy(a), torch.from_numpy(b),
                                mode)
    ref = getattr(jiou, name)()(jnp.asarray(a), jnp.asarray(b), mode)
    assert type(reg.BOXES.get(name)()).__module__ == tiou.__name__
    _close(got, ref, rtol=1e-5, atol=1e-5)
    assert (np.asarray(ref) > 0.1).sum() > 5


@pytest.mark.parametrize("cls,calc", [
    ("MaxIoUAssigner", dict(type="BboxOverlaps2D_rotated")),
    ("MaxIoUAssignerRbbox", None), ("MaxIoUAssignerRbbox",
                                    dict(type="BboxOverlaps2D_v1"))],
    ids=["calculator_rotated", "rbbox", "rbbox_hbb_calculator"])
def test_rotated_assignment_matches(cls, calc):
    """The assigner takes rotated IoU from its calculator's name, and
    ``MaxIoUAssignerRbbox`` whatever the name: both as in JAX."""
    rng = np.random.RandomState(5)
    gts = _obbs(rng, 6)
    boxes = np.concatenate([gts + rng.randn(6, 5).astype(np.float32)
                            * [1, 1, 1, 1, 0.05] for _ in range(4)]
                           + [_obbs(rng, 20)]).astype(np.float32)
    mask = np.asarray([True] * 5 + [False])
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.3,
              iou_calculator=calc)
    jcls = {"MaxIoUAssigner": JAssigner,
            "MaxIoUAssignerRbbox": JAssignerRbbox}[cls]
    port = {"MaxIoUAssigner": MaxIoUAssigner,
            "MaxIoUAssignerRbbox": MaxIoUAssignerRbbox}[cls](**kw)
    assert port.rotated and reg.BOXES.get(cls) is type(port)
    got, got_max = port.assign(torch.from_numpy(boxes), torch.from_numpy(gts),
                               torch.from_numpy(mask))
    ref, ref_max = jcls(**kw).assign(jnp.asarray(boxes), jnp.asarray(gts),
                                     jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _close(got_max, ref_max, atol=1e-5)
    assert (got.numpy() > 0).sum() >= 10


def test_rotated_sampler_is_the_random_sampler():
    """``RandomSamplerRotated`` samples as ``RandomSampler`` (counts,
    budget, positives first): JAX's never looks at the boxes either."""
    assigned = torch.tensor([[0, 3, -1, 0, 1, 0, 2, 0, 0, 1] * 4])
    s = RandomSamplerRotated(num=12, pos_fraction=0.25)
    assert reg.BOXES.get("RandomSamplerRotated") is RandomSamplerRotated
    pos, neg = s.sample(assigned, torch.Generator().manual_seed(0))
    assert int(pos.sum()) == 3 and int(neg.sum()) == 9
    assert not (pos & neg).any() and bool((assigned[pos] > 0).all())
    assert bool((assigned[neg] == 0).all())


FPN_MODES = [("on_input", False), ("on_lateral", False),
             ("on_output", True), (True, True)]


@pytest.mark.parametrize("mode,relu", FPN_MODES,
                         ids=["on_input", "on_lateral", "on_output_relu",
                              "true_relu"])
def test_fpn_extra_convs_match(mode, relu):
    """Three extra levels by stride-2 convs on the input, lateral or
    output (``True`` is ``on_input``), ReLU before all but the first."""
    dims = (8, 16, 24, 32)
    rng = np.random.RandomState(6)
    feats = _nhwc(rng, [(2, 32, 32, 8), (2, 16, 16, 16), (2, 8, 8, 24),
                        (2, 4, 4, 32)])
    kw = dict(in_channels=dims, out_channels=16, num_outs=7,
              add_extra_convs=mode, relu_before_extra_convs=relu)
    jm = JFPN(**kw)
    v = _init(jm, 6, _j(feats))
    port = load_jax_variables(FPN(**kw).eval(), v)
    assert "extra_conv_2" in dict(port.named_modules())
    ref = jax.jit(jm.apply)(v, _j(feats))
    got = port(_t(feats))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-4, atol=1e-4)


def _hrois(rng, n, img, b=2):
    """(batch, x1, y1, x2, y2) rois, some past the border, some tiny."""
    xy = rng.uniform(-0.2, 1.1, (n, 2)) * img
    wh = np.exp(rng.uniform(np.log(0.3), np.log(img), (n, 2)))
    return np.concatenate([rng.randint(0, b, (n, 1)), xy, xy + wh],
                          1).astype(np.float32)


@pytest.mark.parametrize("scale", [0.25, 0.125])
def test_roi_align_matches(scale):
    """Forward and the gradient of the features, rois past every border
    and below one pixel (the ``max(., 1)`` size and the out-of-range
    samples), at C = 12, in more than one chunk."""
    rng = np.random.RandomState(7)
    feat = rng.randn(2, 16, 20, 12).astype(np.float32)
    rois = _hrois(rng, ra._CHUNK + 200, 16 / scale)
    cot = rng.randn(len(rois), 7, 7, 12).astype(np.float32)
    ref, vjp = jax.vjp(lambda f: jroi_align(f, jnp.asarray(rois), 7, scale,
                                             2), jnp.asarray(feat))
    f = torch.from_numpy(feat).requires_grad_()
    got = ra.ROIAlign(7, scale, 2)(f, torch.from_numpy(rois))
    (got * torch.from_numpy(cot)).sum().backward()
    _close(got, ref, atol=1e-5)
    _close(f.grad, vjp(jnp.asarray(cot))[0], atol=1e-4)


def _pyramid(rng, c=8, b=2):
    return _nhwc(rng, [(b, 16, 16, c), (b, 8, 8, c), (b, 4, 4, c),
                       (b, 2, 2, c), (b, 1, 1, c)])


def test_single_extractor_matches():
    """Each roi pooled at its own level equals JAX's masked sum over all
    levels; rois of every level (sqrt area 6-600 px at strides 4-32)."""
    rng = np.random.RandomState(8)
    feats = _pyramid(rng)
    rois = _hrois(rng, 120, 64.0)
    rois[:60, 3:] = rois[:60, 1:3] + np.exp(
        rng.uniform(np.log(100), np.log(600), (60, 2)))
    lvl = ra.map_roi_levels(torch.from_numpy(rois[:, 3] - rois[:, 1]),
                            torch.from_numpy(rois[:, 4] - rois[:, 2]), 4)
    assert set(lvl.tolist()) == {0, 1, 2, 3}
    got = text.SingleRoIExtractor()(_t(feats), torch.from_numpy(rois))
    ref = jext.SingleRoIExtractor()(_j(feats), jnp.asarray(rois))
    _close(got, ref, atol=1e-5)
    assert reg.ROI_EXTRACTORS.get("SingleRoIExtractor") is \
        text.SingleRoIExtractor


def test_rbox_extractor_matches():
    rng = np.random.RandomState(9)
    feats = _pyramid(rng)
    rois = np.concatenate([rng.randint(0, 2, (60, 1)), _obbs(rng, 60)],
                          1).astype(np.float32)
    got = reg.ROI_EXTRACTORS.get("RboxSingleRoIExtractor")()(
        _t(feats), torch.from_numpy(rois))
    ref = jext.RboxSingleRoIExtractor()(_j(feats), jnp.asarray(rois))
    _close(got, ref, atol=2e-5)


def _loss_inputs(rng, n=64):
    gts = _obbs(rng, n)
    preds = (gts + rng.randn(n, 5) * [2, 2, 3, 3, 0.2]).astype(np.float32)
    preds[:, 2:4] = np.abs(preds[:, 2:4]) + 1
    d = rng.randn(n, 5).astype(np.float32) * 0.3
    t = rng.randn(n, 5).astype(np.float32) * 0.3
    w = (rng.rand(n) > 0.3).astype(np.float32)
    return preds, gts, d, t, w


@pytest.mark.parametrize("fn,kw", [
    ("gwd_loss", dict(fun="sqrt")), ("gwd_loss", dict(fun="log1p")),
    ("gwd_loss", dict(fun="none")), ("kld_loss", dict(fun="log1p")),
    ("kld_loss", dict(fun="sqrt")), ("kfiou_loss", {}),
    ("kfiou_loss", dict(fun="ln")), ("kfiou_loss", dict(fun="exp"))],
    ids=["gwd_sqrt", "gwd_log1p", "gwd_scaled", "kld_log1p", "kld_sqrt",
         "kfiou", "kfiou_ln", "kfiou_exp"])
def test_gaussian_losses_match(fn, kw):
    """Value and gradient (of the decoded prediction, or for KFIoU of
    both the deltas and the decoded prediction), weighted, averaged over
    ``avg_factor``."""
    rng = np.random.RandomState(10)
    preds, gts, d, t, w = _loss_inputs(rng)
    kf = fn == "kfiou_loss"

    def jax_fn(p, dd):
        args = (dd, jnp.asarray(t)) if kf else (p, jnp.asarray(gts))
        extra = dict(pred_decode=p, targets_decode=jnp.asarray(gts)) \
            if kf else {}
        return getattr(jloss, fn)(*args, weight=jnp.asarray(w),
                                  avg_factor=17.0, **extra, **kw)

    ref, (gp, gd) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
        jnp.asarray(preds), jnp.asarray(d))
    p = torch.from_numpy(preds).requires_grad_()
    dd = torch.from_numpy(d).requires_grad_()
    args = (dd, torch.from_numpy(t)) if kf else (p, torch.from_numpy(gts))
    extra = dict(pred_decode=p, targets_decode=torch.from_numpy(gts)) \
        if kf else {}
    got = getattr(tloss, fn)(*args, weight=torch.from_numpy(w),
                             avg_factor=17.0, **extra, **kw)
    got.backward()
    _close(got, ref, rtol=1e-5, atol=1e-6)
    _close(p.grad, gp, rtol=1e-4, atol=1e-6)
    if kf:
        _close(dd.grad, gd, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("loss_type", ["gwd", "kld", "kfiou"])
def test_gdloss_matches(loss_type):
    rng = np.random.RandomState(11)
    preds, gts, d, t, w = _loss_inputs(rng, 32)
    w2 = np.repeat(w[:, None], 5, 1)
    kw = dict(loss_type=loss_type, fun="ln" if loss_type == "kfiou"
              else "log1p", tau=1.5, loss_weight=0.5)
    dec = dict(pred_decode=preds, targets_decode=gts)
    ref = jloss.GDLoss(**kw)(jnp.asarray(d if loss_type == "kfiou"
                                         else preds),
                             jnp.asarray(t if loss_type == "kfiou" else gts),
                             weight=jnp.asarray(w2), avg_factor=9.0,
                             **{k: jnp.asarray(v) for k, v in dec.items()})
    got = reg.LOSSES.get("GDLoss")(**kw)(
        torch.from_numpy(d if loss_type == "kfiou" else preds),
        torch.from_numpy(t if loss_type == "kfiou" else gts),
        weight=torch.from_numpy(w2), avg_factor=9.0,
        **{k: torch.from_numpy(v) for k, v in dec.items()})
    _close(got, ref, rtol=1e-5, atol=1e-6)


def test_rpn_head_matches(first_k):
    """Forward, ``get_proposals`` fed the JAX forward's outputs (per-level
    top-k, cap, decode, level-offset NMS, padding), and the loss on the
    gt hbbs (first-k sampling on both sides)."""
    rng = np.random.RandomState(12)
    feats = _pyramid(rng, c=24)
    kw = dict(in_channels=24, feat_channels=24, nms_pre=100, nms_post=300,
              pre_nms_cap=250, target_stds=(0.5, 0.5, 1.0, 1.0))
    jm = JRPN(**kw)
    v = _init(jm, 12, _j(feats))
    for name in ("rpn_cls", "rpn_reg"):
        v["params"][name]["kernel"] *= 40.0
    port = load_jax_variables(RPNHead(**kw), v)
    cls_j, reg_j = jax.jit(jm.apply)(v, _j(feats))
    cls_t, reg_t = port(_t(feats))
    for g, r in zip(cls_t + reg_t, cls_j + reg_j):
        _close(g, r, rtol=1e-4, atol=1e-4)

    img_hw = jnp.full((2, 2), 64.0)
    props, scores, valid = (np.asarray(a) for a in jax.jit(
        lambda *a: jm.apply(*a, method=jm.get_proposals))(
            v, cls_j, reg_j, img_hw))
    got = port.get_proposals(_t(cls_j), _t(reg_j))
    assert props.shape == (2, 300, 4) and 0 < valid.sum() < valid.size
    np.testing.assert_array_equal(got[2].numpy(), valid)
    s = scores[valid]
    assert np.unique(s).size == s.size
    _close(got[1], scores, rtol=1e-6, atol=1e-7)
    _close(got[0].numpy()[valid], props[valid], rtol=1e-5, atol=1e-3)

    hbb = _hbbs(rng, 5, lead=(2,))
    mask = np.asarray([[True] * 5, [True] * 3 + [False] * 2])
    tj = dict(hboxes=jnp.asarray(hbb), gt_mask=jnp.asarray(mask),
              img_hw=img_hw)
    ref = jax.jit(lambda v, c, r: jm.apply(
        v, c, r, tj, jax.random.PRNGKey(0), method=jm.loss))(v, cls_j, reg_j)
    tt = dict(hboxes=torch.from_numpy(hbb), gt_mask=torch.from_numpy(mask),
              img_hw=torch.full((2, 2), 64.0))
    got = port.loss(_t(cls_j), _t(reg_j), tt, None)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], rtol=1e-5, atol=1e-6)
        assert float(got[k]) > 0


HEAD_KW = dict(num_classes=5, in_channels=8, sampler_num=24,
               pos_fraction=0.5, featmap_strides=[4, 8, 16, 32])


def _head_case(rng, b=2, p=30, g=5):
    feats = _pyramid(rng)
    props = _hbbs(rng, p, lead=(b,))
    valid = rng.rand(b, p) > 0.2
    rbox = _obbs(rng, g, lead=(b,))
    # half the proposals sit near a ground truth, so both stages have
    # positives
    props[:, :g] = np.asarray(JB.obb2hbb(jnp.asarray(rbox))) \
        + rng.randn(b, g, 4).astype(np.float32)
    hbb = np.asarray(JB.obb2hbb(jnp.asarray(rbox)))
    mask = np.ones((b, g), bool)
    mask[1, -1] = False
    labels = rng.randint(1, HEAD_KW["num_classes"] + 1, (b, g))
    targets = dict(rboxes=rbox, hboxes=hbb, gt_mask=mask, labels=labels)
    return feats, props, valid, targets


@pytest.mark.parametrize("stages,reg_loss", [(2, "smooth_l1"), (2, "kfiou"),
                                             (1, "smooth_l1")],
                         ids=["cascade", "kfiou", "one_stage"])
def test_head_loss_matches(first_k, stages, reg_loss):
    """Both stages' losses and every weight's gradient (first-k
    sampling), negatives among the slots: KFIoU stays finite."""
    rng = np.random.RandomState(13)
    feats, props, valid, tg = _head_case(rng)
    kw = dict(HEAD_KW, num_stages=stages, reg_loss=reg_loss)
    jm = JHead(**kw)
    jt = {k: jnp.asarray(v) for k, v in tg.items()}
    args = (_j(feats), jnp.asarray(props), jnp.asarray(valid), jt,
            jax.random.PRNGKey(0))
    v = _init(jm, 13, *args, method=jm.loss)
    for st in ("stage1", "stage2")[:stages]:
        v["params"][st]["fc_reg"]["kernel"] *= 100.0

    def jloss_fn(params):
        out = jm.apply({"params": params}, *args, method=jm.loss)
        return sum(out.values()), out

    (_, ref), grads = jax.value_and_grad(jloss_fn, has_aux=True)(v["params"])
    port = load_jax_variables(RoITransformerHead(**kw), v)
    got = port.loss(_t(feats), torch.from_numpy(props),
                    torch.from_numpy(valid),
                    {k: torch.from_numpy(np.asarray(x)) for k, x in
                     tg.items()}, None)
    assert set(got) == set(ref)
    for k in ref:
        assert np.isfinite(float(ref[k])) and float(ref[k]) > 0, k
        _close(got[k], ref[k], rtol=1e-4, atol=1e-6)
    sum(got.values()).backward()
    want = jax_to_state_dict({"params": jax.tree_util.tree_map(np.asarray,
                                                               grads)})
    for name, prm in port.named_parameters():
        assert torch.isfinite(prm.grad).all(), name
        _close(prm.grad, want[name], rtol=1e-3,
               atol=1e-4 * np.abs(want[name]).max())


def test_kfiou_with_negatives_stays_finite():
    """The KFIoU branch with negatives among the slots and the RPN's
    padding (zero boxes, not valid) among the proposals, so stage 2 meets
    w = h = 0 boxes: the loss and every gradient stay finite (the
    negatives' inputs are masked to unit boxes before the loss)."""
    rng = np.random.RandomState(14)
    feats, props, valid, tg = _head_case(rng, p=40)
    props[:, -16:] = 0.0
    valid[:, -16:] = False
    head = RoITransformerHead(**dict(HEAD_KW, reg_loss="kfiou"))
    with torch.no_grad():
        head.stage2.fc_reg.weight.normal_(0, 0.1)
    fs = [f.requires_grad_() for f in _t(feats)]
    out = head.loss(fs, torch.from_numpy(props), torch.from_numpy(valid),
                    {k: torch.from_numpy(np.asarray(x)) for k, x in
                     tg.items()}, torch.Generator().manual_seed(0))
    assert all(torch.isfinite(x) for x in out.values())
    assert float(out["rbbox_reg_loss_2"]) > 0
    sum(out.values()).backward()
    # the levels that pooled a roi
    grads = [p.grad for p in head.parameters() if p.grad is not None] \
        + [f.grad for f in fs if f.grad is not None]
    assert fs[0].grad is not None and head.stage2.fc_reg.weight.grad.abs() \
        .sum() > 0
    assert all(torch.isfinite(g_).all() for g_ in grads)


def test_head_predict_matches():
    rng = np.random.RandomState(15)
    feats, props, valid, _ = _head_case(rng)
    scale = np.asarray([1.0, 0.5], np.float32)
    for stages in (2, 1):
        kw = dict(HEAD_KW, num_stages=stages)
        jm = JHead(**kw)
        args = (_j(feats), jnp.asarray(props), jnp.asarray(valid),
                jnp.asarray(scale))
        v = _init(jm, 15, *args, method=jm.predict)
        for st in ("stage1", "stage2")[:stages]:
            v["params"][st]["fc_reg"]["kernel"] *= 100.0
        port = load_jax_variables(RoITransformerHead(**kw), v)
        ref = jax.jit(lambda *a: jm.apply(*a, method=jm.predict))(v, *args)
        got = port.predict(_t(feats), torch.from_numpy(props),
                           torch.from_numpy(valid), torch.from_numpy(scale))
        np.testing.assert_array_equal(got["valid"].numpy(),
                                      np.asarray(ref["valid"]))
        _close(got["scores"], ref["scores"], rtol=1e-5, atol=1e-6)
        _close(got["polys"], ref["polys"], rtol=1e-5, atol=1e-3)
