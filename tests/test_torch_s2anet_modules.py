"""The modules of the S2ANet slice against their JAX twins on the CPU,
f32, from the same numpy-seeded inputs (and, for modules with weights,
the JAX init perturbed and carried across by ``load_jax_variables``):
the rotated anchor generators (bit equal), ``PseudoSampler``,
``anchor_target_single`` on per-image rotated anchors, the focal and
smooth-L1 losses and their config classes, ``AlignConv`` (its offsets
and output), ``ORConv2d`` (the rank-3 ARF kernel carried as it is) and
``S2ANetHead``'s forward, ``loss`` and ``get_bboxes``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.models.boxes import anchor_generator as jag
from rs_detection_tpu.models.boxes.anchor_target import \
    anchor_target_single as janchor_target
from rs_detection_tpu.models.boxes.assigner import \
    MaxIoUAssigner as JAssigner
from rs_detection_tpu.models.boxes.coder import \
    DeltaXYWHABBoxCoder as JCoder
from rs_detection_tpu.models.boxes.sampler import \
    PseudoSampler as JPseudoSampler
from rs_detection_tpu.models.losses import common as jlosses
from rs_detection_tpu.models.roi_heads import s2anet_head as jhead
from rs_detection_tpu_torch.models.boxes import anchor_generator as tag
from rs_detection_tpu_torch.models.boxes.anchor_target import \
    anchor_target_single
from rs_detection_tpu_torch.models.boxes.assigner import MaxIoUAssigner
from rs_detection_tpu_torch.models.boxes.coder import DeltaXYWHABBoxCoder
from rs_detection_tpu_torch.models.boxes.sampler import PseudoSampler
from rs_detection_tpu_torch.models.losses import common as tlosses
from rs_detection_tpu_torch.models.roi_heads.s2anet_head import (
    AlignConv, ORConv2d, S2ANetHead)
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

RTOL = 1e-4      # f32 through a few 3x3 convs and a deformable gather


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rtol * max(np.abs(want).max(), 1e-6))


# -------------------------------------------------------------- anchors

@pytest.mark.parametrize("cls,kw", [
    ("AnchorGeneratorRotatedS2ANet", dict(scales=[4], ratios=[1.0])),
    ("AnchorGeneratorRotatedS2ANet", dict(scales=[2, 4], ratios=[0.5, 1, 2],
                                          angles=[0.0, 0.5])),
    ("AnchorGeneratorYangXue", dict(scales=[4], ratios=[0.5, 2.0])),
    ("AnchorGeneratorRotated", dict(scales=[3], ratios=[1.0], ctr=(1, 2)))])
@pytest.mark.parametrize("stride,size", [(8, (128, 128)), (16, (5, 7)),
                                         (128, (8, 8))])
def test_rotated_anchors_equal_jax(cls, kw, stride, size):
    got = getattr(tag, cls)(stride, **kw)
    ref = getattr(jag, cls)(stride, **kw)
    np.testing.assert_array_equal(got.base_anchors, ref.base_anchors)
    np.testing.assert_array_equal(got.grid_anchors(size, stride),
                                  ref.grid_anchors(size, stride))
    np.testing.assert_array_equal(got.valid_flags(size, (3, 4)),
                                  ref.valid_flags(size, (3, 4)))
    assert cls in reg.BOXES


# ------------------------------------------------- sampler and targets

def test_pseudo_sampler_keeps_every_candidate():
    a = torch.tensor([[-1, 0, 2, 1, 0], [3, -1, -1, 0, 0]])
    pos, neg = PseudoSampler().sample(a, None)
    jp, jn = JPseudoSampler().sample(jnp.asarray(a.numpy()[0]))
    assert pos[0].tolist() == np.asarray(jp).tolist()
    assert neg[0].tolist() == np.asarray(jn).tolist()
    assert pos.tolist() == (a > 0).tolist() and neg.tolist() == (
        a == 0).tolist()


def _gts():
    rng = np.random.RandomState(2)
    g = np.zeros((2, 6, 5), np.float32)
    g[:, :5] = np.stack([rng.uniform(10, 54, (2, 5)),
                         rng.uniform(10, 54, (2, 5)),
                         rng.uniform(6, 30, (2, 5)),
                         rng.uniform(4, 16, (2, 5)),
                         rng.uniform(-1.5, 1.5, (2, 5))], -1)
    mask = np.zeros((2, 6), bool)
    mask[0, :5] = True
    mask[1, :3] = True
    labels = np.zeros((2, 6), np.int32)
    labels[:, :5] = rng.randint(1, 4, (2, 5))
    return g, mask, labels


def test_anchor_target_on_per_image_anchors_matches_jax():
    """S2ANet's ODM round: each image its own refined anchors [B, A, 5],
    rotated max-IoU assignment (0.5 / 0.4, low-quality rescue), every
    candidate kept, rotated-delta targets and the matched labels."""
    rng = np.random.RandomState(1)
    base = jag.AnchorGeneratorRotatedS2ANet(8, [4], [1.0]).grid_anchors(
        (8, 8), 8)
    anchors = np.stack([base, base]).astype(np.float32)
    anchors[..., :2] += rng.randn(2, 64, 2) * 3
    anchors[..., 2:4] *= rng.uniform(0.4, 1.2, (2, 64, 2))
    anchors[..., 4] = rng.uniform(-1.5, 1.5, (2, 64))
    g, mask, labels = _gts()
    asn = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0,
               iou_calculator=dict(type="BboxOverlaps2D_rotated"))
    jcoder = JCoder()

    def per_image(a, gg, m, lab):
        return janchor_target(a, jnp.ones(a.shape[0], bool), gg, m, lab,
                              JAssigner(**asn), JPseudoSampler(),
                              jcoder.encode)

    ref = jax.vmap(per_image)(jnp.asarray(anchors), jnp.asarray(g),
                              jnp.asarray(mask), jnp.asarray(labels))
    got = anchor_target_single(
        torch.from_numpy(anchors), torch.ones(64, dtype=torch.bool),
        torch.from_numpy(g), torch.from_numpy(mask), torch.from_numpy(labels),
        MaxIoUAssigner(**asn), PseudoSampler(), DeltaXYWHABBoxCoder().encode,
        None)
    for k in ("labels", "num_pos", "num_neg", "assigned_gt_inds"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    for k in ("label_weights", "bbox_weights"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), k)
    np.testing.assert_allclose(got.bbox_targets.numpy(),
                               np.asarray(ref.bbox_targets), atol=1e-5)
    assert got.num_pos.min() > 0 and (got.labels > 1).any()


# --------------------------------------------------------------- losses

def test_sigmoid_focal_loss_with_background_rows_matches_jax():
    """Rows with label 0 are all-zero one-hot rows (the ``jax.nn.one_hot``
    of -1, which ``torch.nn.functional.one_hot`` refuses); weights with
    ignored rows; the config classes with their loss weights."""
    rng = np.random.RandomState(4)
    pred = (3 * rng.randn(40, 5)).astype(np.float32)
    lab = rng.randint(0, 6, 40)
    lab[:10] = 0
    w = (rng.rand(40) > 0.2).astype(np.float32)
    onehot = np.array(jax.nn.one_hot(lab - 1, 5))
    assert not onehot[:10].any()
    ref = jlosses.sigmoid_focal_loss(jnp.asarray(pred), jnp.asarray(onehot),
                                     jnp.asarray(w), 2.0, 0.25,
                                     avg_factor=7.0)
    got = tlosses.sigmoid_focal_loss(torch.from_numpy(pred),
                                     torch.from_numpy(onehot),
                                     torch.from_numpy(w), 2.0, 0.25,
                                     avg_factor=7.0)
    assert abs(got.item() - float(ref)) <= 1e-6 * abs(float(ref))
    jf = jlosses.FocalLoss(gamma=1.5, alpha=0.3, loss_weight=2.0)
    tf = reg.LOSSES.get("FocalLoss")(gamma=1.5, alpha=0.3, loss_weight=2.0)
    assert abs(tf(torch.from_numpy(pred), torch.from_numpy(lab),
                  torch.from_numpy(w), 5.0).item()
               - float(jf(jnp.asarray(pred), jnp.asarray(lab),
                          jnp.asarray(w), 5.0))) < 1e-5
    big = np.array([[80.0, -80.0, 0.0]], np.float32)
    np.testing.assert_allclose(
        tlosses.sigmoid_bce(torch.from_numpy(big),
                            torch.tensor([[0.0, 1.0, 1.0]])).numpy(),
        np.asarray(jlosses.optax_sigmoid_bce(jnp.asarray(big),
                                             jnp.asarray([[0., 1., 1.]]))),
        rtol=1e-6)
    p2, t2 = rng.randn(30, 5).astype(np.float32), rng.randn(30, 5).astype(
        np.float32)
    ws = (rng.rand(30, 5) > 0.5).astype(np.float32)
    js = jlosses.SmoothL1Loss(beta=1 / 9, loss_weight=0.5)
    ts = reg.LOSSES.get("SmoothL1Loss")(beta=1 / 9, loss_weight=0.5)
    assert abs(ts(*map(torch.from_numpy, (p2, t2, ws)), 4.0).item()
               - float(js(*map(jnp.asarray, (p2, t2, ws)), 4.0))) < 1e-5


# ------------------------------------------------- AlignConv, ORConv

def _refined(rng, n, h, w, stride):
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    a = np.zeros((n, h, w, 5), np.float32)
    a[..., 0] = (xs + rng.randn(n, h, w)) * stride
    a[..., 1] = (ys + rng.randn(n, h, w)) * stride
    a[..., 2] = rng.uniform(0.5, 6, (n, h, w)) * stride
    a[..., 3] = rng.uniform(0.5, 3, (n, h, w)) * stride
    a[..., 4] = rng.uniform(-1.5, 1.5, (n, h, w))
    return a


def test_align_conv_matches_jax():
    """Offsets (tap (i, j) of every position, the y-outer order and the
    [1, H, 1, K*K] row grid) and the ReLU output, from the carried
    HWIO kernel; offsets reach no gradient."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 6, 7, 8).astype(np.float32)
    a = _refined(rng, 2, 6, 7, 8)
    jm = jhead.AlignConv(feat_channels=12, kernel_size=3)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(a), 8)
    v = {"params": {"kernel": np.asarray(v["params"]["kernel"]) * 30}}
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(a), 8)
    port = load_jax_variables(AlignConv(8, 12), v)
    tx = torch.from_numpy(x)
    ta = torch.from_numpy(a).requires_grad_(True)
    got = port(tx, ta, 8)
    _close(got.detach().numpy(), ref)
    assert (np.asarray(ref) > 0).mean() > 0.3
    got.sum().backward()
    assert ta.grad is None or not ta.grad.any()
    off = port.offsets(torch.from_numpy(a), 8).numpy()
    # tap 0 (dy, dx) of position (2, 3): the anchor's rotated (-1, -1)
    # cell minus the conv grid's (2 - 1, 3 - 1)
    cx, cy, w, h, t = a[0, 2, 3] / [8, 8, 8, 8, 1]
    px, py = -w / 3, -h / 3
    want_x = np.cos(t) * px - np.sin(t) * py + cx - 2
    want_y = np.sin(t) * px + np.cos(t) * py + cy - 1
    np.testing.assert_allclose(off[0, 2, 3, :2], [want_y, want_x], atol=1e-5)


def test_or_conv_matches_jax():
    """The rank-3 flax kernel [Cout, Cin, 9] carried as it is, rotated to
    8 orientations, conv'd at padding 1, with its bias."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 5, 6, 16).astype(np.float32)
    jm = jhead.ORConv2d(16, 2, n_orientation=1, n_rotation=8)
    v = perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), seed=2)
    assert v["params"]["kernel"].shape == (2, 16, 9)
    ref = jm.apply(v, jnp.asarray(x))
    port = load_jax_variables(ORConv2d(16, 2), v)
    np.testing.assert_array_equal(port.weight.detach().numpy(),
                                  v["params"]["kernel"])
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.detach().numpy(), ref)


# ------------------------------------------------------------ the head

SIZES = ((16, 16), (8, 8), (4, 4))
STRIDES = (4, 8, 16)


def _head_kw(**kw):
    return dict(dict(num_classes=4, in_channels=16, feat_channels=16,
                     anchor_strides=STRIDES, nms_pre=40, max_per_img=24,
                     score_thr=0.02), **kw)


def _head_inputs(seed=7):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(2, h, w, 16).astype(np.float32) for h, w in SIZES]
    g, mask, labels = _gts()
    return feats, dict(rboxes=g, gt_mask=mask, labels=labels,
                       scale_factor=np.asarray([1.0, 0.5], np.float32))


_HEADS = {}


def _head_pair(with_orconv):
    if with_orconv not in _HEADS:
        feats, _ = _head_inputs()
        jm = jhead.S2ANetHead(**_head_kw(with_orconv=with_orconv))
        v = jm.init(jax.random.PRNGKey(3), [jnp.asarray(f) for f in feats],
                    train=True)
        v = perturb(v, seed=5)
        # logits around 0 (not the prior's -4.6), spread, so that scores
        # pass the threshold and do not tie
        v["params"]["odm_cls_out"]["kernel"] *= 60.0
        v["params"]["odm_cls_out"]["bias"] = np.random.RandomState(
            6).randn(3).astype(np.float32)
        port = load_jax_variables(
            S2ANetHead(**_head_kw(with_orconv=with_orconv)), v)
        _HEADS[with_orconv] = jm, v, port
    return _HEADS[with_orconv]


@pytest.mark.parametrize("with_orconv", [True, False],
                         ids=["orconv", "plain"])
def test_head_forward_matches_jax(with_orconv):
    feats, _ = _head_inputs()
    jm, v, port = _head_pair(with_orconv)
    ref = jm.apply(v, [jnp.asarray(f) for f in feats], train=True)
    got = port(tuple(torch.from_numpy(f) for f in feats), train=True)
    assert len(got) == 5 and all(len(o) == 3 for o in got)
    for name, g_out, r_out in zip(("fam_cls", "fam_reg", "refined",
                                   "odm_cls", "odm_reg"), got, ref):
        for lvl, (g_, r_) in enumerate(zip(g_out, r_out)):
            assert g_.shape == r_.shape, (name, lvl)
            _close(g_.detach().numpy(), r_)
    eval_out = port(tuple(torch.from_numpy(f) for f in feats), train=False)
    assert all(c is None for c in eval_out[0])


@pytest.mark.parametrize("with_orconv", [True, False],
                         ids=["orconv", "plain"])
def test_head_loss_matches_jax(with_orconv):
    """The four losses to 1e-4 relative, each above 0."""
    feats, targets = _head_inputs()
    jm, v, port = _head_pair(with_orconv)
    jt = {k: jnp.asarray(a) for k, a in targets.items()}
    ref = jm.apply(v, [jnp.asarray(f) for f in feats], jt,
                   method=lambda m, f, t: m.loss(m(f, train=True), t))
    tt = {k: torch.from_numpy(a) for k, a in targets.items()}
    got = port.loss(port(tuple(torch.from_numpy(f) for f in feats),
                         train=True), tt)
    assert set(got) == set(ref) == {"loss_fam_cls", "loss_fam_bbox",
                                    "loss_odm_cls", "loss_odm_bbox"}
    for k in ref:
        assert got[k].item() > 0
        assert abs(got[k].item() - float(ref[k])) <= RTOL * abs(
            float(ref[k])), k


@pytest.mark.parametrize("with_orconv", [True, False],
                         ids=["orconv", "plain"])
def test_head_get_bboxes_matches_jax(with_orconv):
    """The same valid slots and labels, polys to 1e-3 px, scores to 1e-5;
    the second image's boxes divided by its scale factor 0.5."""
    feats, targets = _head_inputs()
    jm, v, port = _head_pair(with_orconv)
    jt = {"scale_factor": jnp.asarray(targets["scale_factor"])}
    ref = jm.apply(v, [jnp.asarray(f) for f in feats], jt,
                   method=lambda m, f, t: m.get_bboxes(m(f, train=False), t))
    with torch.no_grad():
        got = port.get_bboxes(port(tuple(torch.from_numpy(f) for f in feats)),
                              torch.from_numpy(targets["scale_factor"]))
    valid = np.asarray(ref["valid"])
    assert 8 < valid.sum() and got["polys"].shape == (2, 24, 8)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(ref["labels"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["polys"].numpy(), np.asarray(ref["polys"]),
                               atol=1e-3)
