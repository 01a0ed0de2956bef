"""Gliding Vertex in the port against the JAX package, CPU, f32: the box
helpers (``hbb2poly``, ``poly2hbb``, ``get_bbox_areas``) and the coders
(``GVFixCoder``, ``GVRatioCoder``) on random and on axis-aligned quads,
where two vertices tie on every side and the first one must count; the
``GlidingHead`` forward, predict and loss on the same features and
proposals; and a tiny ``GlidingVertex`` (ResNet-18, a 32-wide FPN, the
hbb RPN, the head with 16 roi slots) built by each framework's registry
from one config, the JAX init (perturbed) carried across by
``load_jax_variables``: ``predict`` and the training losses (first-k
sampling on both sides, as ``tests/test_torch_roitrans_networks.py``),
and a saved JAX tree loading through ``jax_weights``. One module fixture
holds the JAX network and its jitted outputs."""

import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.models.boxes import coder as jcoder
from rs_detection_tpu.models.boxes import sampler as jsampler
from rs_detection_tpu.models.roi_heads.gliding_head import \
    GlidingHead as JGlidingHead
from rs_detection_tpu.ops import box_ops as JB
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.flagship import normalize
from rs_detection_tpu_torch.models.boxes import coder
from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
from rs_detection_tpu_torch.models.networks import \
    gliding_vertex  # noqa: F401  (registers the network)
from rs_detection_tpu_torch.models.roi_heads.gliding_head import GlidingHead
from rs_detection_tpu_torch.ops import box_ops as B
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (load_jax_checkpoint,
                                                      load_jax_variables)
from test_torch_port_slice import perturb
from test_torch_roitrans_cuda import first_k_sample
from test_torch_roitrans_modules import _first_k_jax
from torch_one_thread import _one_thread  # noqa: F401

IMG = 64


def tiny_gliding(fc=64):
    """A tiny Gliding Vertex as a zoo config writes it: ResNet-18 with
    batch statistics, a 32-wide FPN (5 levels, no extra convs, as the
    zoo's), the 32-wide hbb RPN (64 / 32 proposals), the head with the
    zoo's sections at 32 channels, ``fc``-wide FCs and 16 roi slots."""
    return dict(
        type="GlidingVertex",
        backbone=dict(type="ResNet", depth=18, norm_eval=False),
        neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                  out_channels=32, num_outs=5),
        rpn=dict(type="GlidingRPNHead", in_channels=32, feat_channels=32,
                 nms_pre=64, nms_post=32),
        bbox_head=dict(
            type="GlidingHead", num_classes=15, in_channels=32,
            fc_out_channels=fc, ratio_thr=0.8,
            assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                          neg_iou_thr=0.5, min_pos_iou=0.5,
                          match_low_quality=False, ignore_iof_thr=-1,
                          iou_calculator=dict(type="BboxOverlaps2D")),
            sampler=dict(type="RandomSampler", num=16, pos_fraction=0.25,
                         add_gt_as_proposals=True, neg_pos_ub=-1),
            bbox_coder=dict(type="GVDeltaXYWHBBoxCoder",
                            target_means=[0.0] * 4,
                            target_stds=[0.1, 0.1, 0.2, 0.2]),
            bbox_roi_extractor=dict(
                type="SingleRoIExtractor", featmap_strides=[4, 8, 16, 32],
                out_channels=32, roi_layer=dict(type="ROIAlign",
                                                output_size=7,
                                                sampling_ratio=2,
                                                version=1))))


def _quads(rng, n, aligned=False):
    """n convex quads: rotated rectangles (angle 0 when ``aligned``)
    with their vertices slid along the edges, as DOTA labels are."""
    obb = np.concatenate([rng.uniform(10, 54, (n, 2)),
                          rng.uniform(3, 30, (n, 2)),
                          (np.zeros((n, 1)) if aligned
                           else rng.uniform(-np.pi, np.pi, (n, 1)))], 1)
    polys = JB.rotated_box_to_poly_np(obb.astype(np.float32))
    if not aligned:
        pts = polys.reshape(n, 4, 2)
        nxt = np.roll(pts, -1, 1)
        t = rng.uniform(0, 0.3, (n, 4, 1))
        polys = (pts + t * (nxt - pts)).reshape(n, 8)
    return polys.astype(np.float32)


def _data():
    """Two 64^2 tiles with 4 ground truths each (the second image's last
    slot padded): rotated quads, one of them axis-aligned, with their
    hbbs, as the data pipeline gives them."""
    rng = np.random.RandomState(0)
    tiles = rng.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    polys = np.zeros((2, 5, 8), np.float32)
    polys[:, :3] = _quads(rng, 6).reshape(2, 3, 8)
    polys[:, 3] = _quads(rng, 2, aligned=True)
    hboxes = np.asarray(JB.poly2hbb(polys))
    mask = np.zeros((2, 5), bool)
    mask[:, :4] = True
    mask[1, 3] = False
    labels = np.tile(np.asarray([1, 2, 3, 4, 0], np.int32), (2, 1))
    targets = dict(polys=polys, hboxes=hboxes, gt_mask=mask, labels=labels,
                   rboxes=np.zeros((2, 5, 5), np.float32),
                   img_hw=np.full((2, 2), IMG, np.float32))
    return normalize(torch.from_numpy(tiles)).numpy(), targets


# -------------------------------------------------------------- box helpers

@pytest.mark.parametrize("aligned", [False, True], ids=["rotated", "aligned"])
def test_box_helpers_and_coders_match_jax(aligned):
    """``hbb2poly``, ``poly2hbb``, ``get_bbox_areas`` (hbb, obb, quad) and
    both GV coders' encode, and ``GVFixCoder.decode``, within 1e-6 of
    JAX on 64 quads; on axis-aligned quads every glide is 0 or 1 (the
    first of the two tied vertices, as ``jnp.argmin`` picks it) and every
    ratio 1 to f32 rounding of the shoelace sum."""
    rng = np.random.RandomState(3 + aligned)
    polys = _quads(rng, 64, aligned)
    jp = jnp.asarray(polys)
    tp = torch.from_numpy(polys)
    hbb = B.poly2hbb(tp)
    np.testing.assert_allclose(hbb.numpy(), np.asarray(JB.poly2hbb(jp)),
                               atol=1e-6)
    np.testing.assert_allclose(B.hbb2poly(hbb).numpy(),
                               np.asarray(JB.hbb2poly(jnp.asarray(hbb))),
                               atol=1e-6)
    obb = np.concatenate([polys[:, :4], rng.uniform(-1, 1, (64, 1))], 1)
    for x in (polys, hbb.numpy(), obb.astype(np.float32)):
        np.testing.assert_allclose(
            B.get_bbox_areas(torch.from_numpy(x)).numpy(),
            np.asarray(JB.get_bbox_areas(jnp.asarray(x))), rtol=1e-6)
    fix = coder.GVFixCoder().encode(tp)
    ratio = coder.GVRatioCoder().encode(tp)
    np.testing.assert_allclose(
        fix.numpy(), np.asarray(jcoder.GVFixCoder().encode(jp)), atol=1e-6)
    np.testing.assert_allclose(
        ratio.numpy(), np.asarray(jcoder.GVRatioCoder().encode(jp)),
        atol=1e-6)
    deltas = rng.uniform(0, 1, (64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        coder.GVFixCoder().decode(hbb, torch.from_numpy(deltas)).numpy(),
        np.asarray(jcoder.GVFixCoder().decode(jnp.asarray(hbb),
                                              jnp.asarray(deltas))),
        atol=1e-5)
    if aligned:
        assert set(np.unique(fix.numpy())) <= {0.0, 1.0}
        np.testing.assert_allclose(ratio.numpy(), 1.0, atol=2e-5)


def test_fix_coder_takes_the_first_tied_vertex():
    """Two orders of one axis-aligned box, whose tied vertices give
    different glides: in (10, 5), (30, 5), (30, 25), (10, 25) the left
    side's first vertex is (10, 5), a glide of 1 from the bottom; in
    (30, 5), (30, 25), (10, 25), (10, 5) the top side's first vertex is
    (30, 5), a glide of 1 from the left. Both as JAX, bit for bit."""
    for poly, want in (([10.0, 5, 30, 5, 30, 25, 10, 25], [0.0, 0, 0, 1]),
                       ([30.0, 5, 30, 25, 10, 25, 10, 5], [1.0, 0, 0, 0])):
        poly = np.asarray([poly], np.float32)
        got = coder.GVFixCoder().encode(torch.from_numpy(poly)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jcoder.GVFixCoder().encode(jnp.asarray(poly))))
        np.testing.assert_array_equal(got, [want])


# -------------------------------------------------------------- the network

@pytest.fixture(scope="module")
def net():
    """The JAX network with perturbed variables (the RPN's cls conv
    spread so that its scores do not tie), the port's with them, and
    JAX's first-k ``loss``; a copy with the ratio FC spread too (so that
    predict takes both branches of the hbb fallback) in both frameworks,
    and JAX's ``predict`` of it."""
    images, targets = _data()
    cfg = tiny_gliding()
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    v = jax.jit(lambda i, t: jm.init(
        {"params": jax.random.PRNGKey(0), "sampler": jax.random.PRNGKey(1)},
        i, t))(jnp.asarray(images), jt)
    v = perturb(v, seed=7)
    v["params"]["_rpn"]["rpn_cls"]["kernel"] *= 40.0
    mp = pytest.MonkeyPatch()
    mp.setattr(jsampler.RandomSampler, "sample", _first_k_jax)
    try:
        loss, _ = jax.jit(lambda v, i: jm.apply(
            v, i, jt, method=jm.loss, mutable=["batch_stats"],
            rngs={"sampler": jax.random.PRNGKey(2)}))(v, jnp.asarray(images))
    finally:
        mp.undo()
    port = load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v)
    spread = copy.deepcopy(v)
    spread["params"]["_bbox_head"]["fc_ratio"]["kernel"] *= 3000.0
    spread["params"]["_bbox_head"]["fc_ratio"]["bias"][:] = 1.4
    pred = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda v, i: jm.apply(v, i, method=jm.predict))(
        spread, jnp.asarray(images)))
    return dict(images=images, targets=targets, jm=jm, v=v, port=port,
                pred=pred, loss=jax.tree_util.tree_map(float, loss),
                spread=load_jax_variables(
                    reg.build_from_cfg(cfg, reg.MODELS), spread))


def test_tiny_network_predicts_like_jax(net):
    """The same valid proposals, scores to 5e-5 and quads to 1e-3 px (the
    tolerances of ``tests/test_torch_roitrans_networks.py``), with both
    the glided quads and the hbb fallback among the detections."""
    got = net["spread"].eval().predict(torch.from_numpy(net["images"]))
    ref = net["pred"]
    assert ref["valid"].sum() > 16 and got["polys"].shape == (2, 32, 8)
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               atol=5e-5)
    np.testing.assert_allclose(got["polys"].numpy(), ref["polys"], atol=1e-3)
    polys = ref["polys"][ref["valid"]]
    axis = (np.abs(polys[:, 1] - polys[:, 3]) < 1e-4) & \
        (np.abs(polys[:, 0] - polys[:, 6]) < 1e-4)
    assert 0 < axis.sum() < len(polys)


def test_tiny_network_loss_like_jax(net, monkeypatch):
    """The RPN's two losses and the head's four within 1e-5 relative
    (train-mode batch statistics in f32 on both sides), each finite and
    above 0."""
    monkeypatch.setattr(RandomSampler, "sample", first_k_sample)
    got = net["port"].train().loss(
        torch.from_numpy(net["images"]),
        {k: torch.from_numpy(x) for k, x in net["targets"].items()}, None)
    got = {k: float(v.detach()) for k, v in got.items()}
    ref = net["loss"]
    assert set(got) == set(ref) == {
        "loss_rpn_cls", "loss_rpn_bbox", "gliding_cls_loss",
        "gliding_bbox_loss", "gliding_fix_loss", "gliding_ratio_loss"}
    for k, r in ref.items():
        assert np.isfinite(r) and r > 0, (k, r)
        assert abs(got[k] - r) <= 1e-5 * abs(r), (k, got[k], r)


def test_head_alone_matches_jax(net, monkeypatch):
    """``GlidingHead`` on the same FPN levels and proposals: the forward's
    four outputs within 1e-5 of each one's largest entry, the sampled
    losses within 1e-5 relative (first-k sampling, the JAX
    ``sample_rois`` priority and the port's ``sample_slots``)."""
    monkeypatch.setattr(RandomSampler, "sample", first_k_sample)
    monkeypatch.setattr(jsampler.RandomSampler, "sample", _first_k_jax)
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, 64 // s, 64 // s, 32).astype(np.float32)
             for s in (4, 8, 16, 32, 64)]
    xy = rng.uniform(0, 50, (2, 24, 2))
    props = np.concatenate([xy, xy + rng.uniform(4, 40, (2, 24, 2))],
                           -1).astype(np.float32)
    valid = rng.rand(2, 24) > 0.2
    _, targets = _data()
    cfg = {k: v for k, v in tiny_gliding()["bbox_head"].items()
           if k != "type"}
    jh = JGlidingHead(**cfg)
    jf = [jnp.asarray(f) for f in feats]
    rois = jnp.concatenate([jnp.zeros((24, 1)), jnp.asarray(props[0])], 1)
    hv = jh.init(jax.random.PRNGKey(4), jf, rois, method=jh.forward_rois)
    hv = perturb(hv, seed=9)
    head = GlidingHead(**cfg)
    load_jax_variables(head, hv)
    tf = [torch.from_numpy(f) for f in feats]
    ref = jh.apply(hv, jf, rois, method=jh.forward_rois)
    got = head.forward_rois(tf, torch.from_numpy(np.array(rois)))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.detach().numpy(), r,
                                   atol=1e-5 * np.abs(r).max())
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    ref = jh.apply(hv, jf, jnp.asarray(props), jnp.asarray(valid), jt,
                   jax.random.PRNGKey(0), method=jh.loss)
    got = head.loss(tf, torch.from_numpy(props), torch.from_numpy(valid),
                    {k: torch.from_numpy(v) for k, v in targets.items()},
                    None)
    assert set(got) == set(ref)
    for k, r in ref.items():
        r = float(r)
        assert r > 0 and abs(float(got[k]) - r) <= 1e-5 * r, (k, got[k], r)


def test_saved_jax_tree_loads(net, tmp_path):
    """A JAX Gliding Vertex tree pickled as numpy arrays loads through
    ``load_jax_checkpoint`` / ``load_jax_variables`` into every parameter
    of the port, the head's six FCs equal to the tree."""
    path = tmp_path / "gliding.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, net["v"]), f)
    port = reg.build_from_cfg(tiny_gliding(), reg.MODELS)
    load_jax_variables(port, load_jax_checkpoint(str(path)))
    sd = port.state_dict()
    head = net["v"]["params"]["_bbox_head"]
    for name in ("shared_fc0", "shared_fc1", "fc_cls", "fc_reg", "fc_fix",
                 "fc_ratio"):
        np.testing.assert_array_equal(sd[f"bbox_head.{name}.weight"].numpy(),
                                      head[name]["kernel"].T)
        np.testing.assert_array_equal(sd[f"bbox_head.{name}.bias"].numpy(),
                                      head[name]["bias"])
    np.testing.assert_array_equal(
        sd["rpn.rpn_conv.weight"].numpy(),
        net["v"]["params"]["_rpn"]["rpn_conv"]["kernel"].transpose(3, 2, 0, 1))
