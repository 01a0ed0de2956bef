"""SSD in the port against the JAX package, CPU, f32: the anchors of the
zoo's generator bit for bit, then the tiny network of
``tests/test_torch_ssd_cuda.py:tiny_model`` (VGG-16 at its fixed widths
on 96^2 tiles, the neck padded on every extra level so that no level is
empty, 3 classes) built by each framework's registry from one config
section, seeded JAX variables (perturbed) carried across by
``load_jax_variables``: the backbone's two features, the neck's six
levels, the head's outputs, its two losses and their gradient, and
``get_bboxes`` with the classifier spread. Then the port's runner from
the same weights on a rendered COCO-format dataset: ``Runner.run`` (the
train task) takes 2 SGD steps, held to the JAX network's losses at the
iterates of the JAX package's own SGD (its optax chain, applied to the
JAX gradients); ``Runner.test`` (the test task) against JAX ``predict``;
``Runner.val`` on detections equal to the ground truth gives AP 1 per
class. One JAX compile serves every comparison: one batch shape
throughout (2 tiles of 96^2, 4 box slots).

The JAX runner cannot run either task on a ``COCODataset``: its
``postprocess_dense`` reads no [B, P] scores (ROADMAP.md, Queue 3), its
``val`` hands ``evaluate`` (detections, meta) pairs, which it cannot
unpack (pinned here), and ``batches`` takes no ``flip_mode``
(``tests/test_torch_ssd_data.py``)."""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.data import yolo as jyolo
from rs_detection_tpu.models.boxes import anchor_generator as jag
from rs_detection_tpu.optims import optimizer as _joptim  # noqa: F401
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.flagship import normalize
from rs_detection_tpu_torch.models.boxes import anchor_generator as ag
from rs_detection_tpu_torch.models.roi_heads.ssd_head import SSDHead
from rs_detection_tpu_torch.ops import box_ops as B
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_checkpoint,
                                                      load_jax_variables)
from test_torch_fcos_networks import one_thread, random_variables
from test_torch_ssd_cuda import (IMG, assignment_margin, mining_margin,
                                 render_coco, tiny_inputs, tiny_model)

ZOO_ANCHORS = dict(strides=[8, 16, 32, 64, 100, 300],
                   ratios=[[2], [2, 3], [2, 3], [2, 3], [2], [2]],
                   basesize_ratio_range=(0.15, 0.9), input_size=300)
LEVELS = [(37, 37), (18, 18), (9, 9), (5, 5), (3, 3), (1, 1)]
SGD = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4)
LOSSES = ("loss_cls", "loss_bbox")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def test_ssd_anchors_match_jax_bit_for_bit():
    """The zoo's ``SSDAnchorGenerator`` (``ssd300_coco.py``): 5, 9, 9, 9,
    5, 5 anchors a position (JAX's index list; mmdet keeps 4 or 6),
    10,765 at 300^2 (levels 37^2 ... 1^2, the floor-mode pools), equal to
    JAX's bit for bit; and the generic ``AnchorGenerator`` with
    ``centers``."""
    got, ref = ag.SSDAnchorGenerator(**ZOO_ANCHORS), \
        jag.SSDAnchorGenerator(**ZOO_ANCHORS)
    assert got.num_base_anchors == ref.num_base_anchors == [5, 9, 9, 9, 5, 5]
    a = np.concatenate(got.grid_anchors(LEVELS))
    b = np.concatenate(ref.grid_anchors(LEVELS))
    assert a.shape == (10765, 4) and a.dtype == b.dtype == np.float32
    assert np.array_equal(a, b)
    kw = dict(strides=[4, 8], ratios=[0.5, 1.0, 2.0], scales=[8, 12],
              centers=[(1.5, 1.5), (3.5, 3.5)])
    assert all(np.array_equal(x, y) for x, y in zip(
        ag.AnchorGenerator(**kw).grid_anchors([(3, 4), (2, 2)]),
        jag.AnchorGenerator(**kw).grid_anchors([(3, 4), (2, 2)])))


def spread(v, seed=8):
    """Every level's classifier spread (kernel x 60, biases N(0, 1)), so
    that the random head's scores stand apart and pass 0.02."""
    v = copy.deepcopy(v)
    rng = np.random.RandomState(seed)
    for i in range(6):
        cls = v["params"]["_bbox_head"][f"cls_{i}"]
        cls["kernel"] = cls["kernel"] * 60.0
        cls["bias"] = rng.randn(*cls["bias"].shape).astype(np.float32)
    return v


def compile_run(jm):
    """One jitted function of (variables, variables for ``predict``,
    images, targets): the neck's levels (the backbone's two first), the
    head's outputs, the losses, their gradient and ``predict``, as
    numpy."""
    def run(v, sv, images, t):
        def loss_fn(params):
            losses = jm.apply(dict(v, params=params), images, t,
                              method=jm.loss)
            return sum(losses.values()), losses

        (_, losses), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            v["params"])
        feats = jm.apply(v, images, method=lambda m, i: m.extract_feats(i))
        outs = jm.apply(v, images, method=lambda m, i: m._bbox_head(
            m.extract_feats(i)))
        return (feats, outs, losses, grads,
                jm.apply(sv, images, {}, method=jm.predict))

    fn = jax.jit(run)
    return lambda *a: jax.tree_util.tree_map(np.asarray, fn(*a))


def jax_targets(t):
    return dict(hboxes=np.asarray(t["hboxes"], np.float32),
                gt_mask=np.asarray(t["gt_mask"], bool),
                labels=np.asarray(t["labels"], np.int32))


def _use(cfg):
    c = get_cfg()
    c.clear()
    c.update(copy.deepcopy(cfg))


def coco_section(img_dir, ann, **kw):
    """A ``COCODataset`` section in the JAX class's keys at 96^2, batch 2,
    4 box slots (``kw`` overrides)."""
    return dict(dict(type="COCODataset", images_dir=img_dir,
                     annotations_file=ann, img_size=IMG, max_gt=4,
                     batch_size=2), **kw)


def runner_tasks(root, v, sv, run):
    """The port's train task (2 SGD steps over 4 rendered COCO images at
    batch 2) from ``v`` and its test task (2 images) from ``sv``; JAX's
    losses at its SGD's two iterates over the same batches, its
    parameters after them, and its ``predict`` of the test batch."""
    train = render_coco(str(root / "train"), n=4, seed=1)
    test = render_coco(str(root / "test"), n=2, seed=2)
    for name, tree in (("weights", v), ("spread", sv)):
        with open(root / f"{name}.pkl", "wb") as f:
            pickle.dump(tree, f)
    cfg = dict(name="ssd_runner", work_dir=str(root / "train_work"), seed=3,
               max_epoch=1, log_interval=1, checkpoint_interval=1,
               model=tiny_model(), optimizer=SGD,
               pretrained_weights=str(root / "weights.pkl"),
               dataset=dict(train=coco_section(*train), val=None,
                            test=coco_section(*test)))
    _use(cfg)
    trainer = Runner(device="cpu")
    batches = list(trainer.train_dataset.batches(seed=0))
    trainer.run()
    tx = jreg.build_from_cfg(SGD, jreg.OPTIMS)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    state = tx.init(params)
    losses = []
    for images, t, _ in batches:
        _, _, loss, grads, _ = run(dict(v, params=jax.tree_util.tree_map(
            np.asarray, params)), sv, images, jax_targets(t))
        losses.append(loss)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                   state, params)
        params = optax.apply_updates(params, updates)
    _use(dict(cfg, work_dir=str(root / "test_work"),
              pretrained_weights=str(root / "spread.pkl")))
    tester = Runner(device="cpu")
    tester.test()
    with open(root / "test_work" / "test" / "test_0.pkl", "rb") as f:
        results = pickle.load(f)
    images, t, metas = next(iter(tester.test_dataset.batches()))
    return dict(trainer=trainer, batches=batches, jax_losses=losses,
                jax_params=jax_to_state_dict(dict(
                    params=jax.tree_util.tree_map(np.asarray, params))),
                results=results, metas=metas,
                jax_pred=run(v, sv, images, jax_targets(t))[4])


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    tiles, t = tiny_inputs()
    images = normalize(tiles).numpy()
    targets = jax_targets(t)
    cfg = tiny_model()
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    v = random_variables(jm, images.shape, seed=7, heads=("_bbox_head",))
    sv = spread(v)
    run = compile_run(jm)
    feats, outs, loss, grads, pred = run(v, sv, images, targets)
    return dict(
        cfg=cfg, images=images, targets=targets, v=v, feats=feats,
        outs=outs, loss=loss, grads=grads, pred=pred,
        port=load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v),
        spread=load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), sv),
        tasks=runner_tasks(tmp_path_factory.mktemp("ssd_runner"), v, sv,
                           run))


def _close(got, ref, rel):
    """``got`` within ``rel`` of ``ref``'s largest entry."""
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def test_backbone_and_neck_levels_match_jax(net):
    """``SSDVGG``'s L2-normed conv4_3 (12^2) and fc7 (6^2), then the
    neck's four extra levels (3^2, 2^2, 2^2, 2^2), each within 1e-5 of
    its largest entry, NHWC."""
    port = net["port"].eval()
    x = torch.from_numpy(net["images"])
    with torch.no_grad():
        base = port.backbone(x)
        levels = port.neck(base)
    assert [tuple(f.shape[1:3]) for f in levels] == \
        [(12, 12), (6, 6), (3, 3), (2, 2), (2, 2), (2, 2)]
    for got, ref in zip(base, net["feats"][:2]):
        _close(got, ref, 1e-5)
    for got, ref in zip(levels, net["feats"]):
        _close(got, ref, 1e-5)


def test_head_outputs_match_jax(net):
    """Per level the ``cls_{i}`` logits (A x 4 a position) and
    ``reg_{i}`` deltas within 1e-5 of their largest entry."""
    port = net["port"].eval()
    with torch.no_grad():
        outs = port.bbox_head(port.extract_feats(
            torch.from_numpy(net["images"])))
    for got_l, ref_l in zip(outs, net["outs"]):
        for got, ref in zip(got_l, ref_l):
            _close(got, ref, 1e-5)


def test_loss_and_gradient_match_jax(net):
    """The mined cross-entropy and the smooth-L1 loss within 1e-5
    relative, both above 0, and every parameter's gradient within 1e-4 of
    its largest entry, on boxes whose assignment stands 1e-5 from every
    tie and threshold and a hard-negative cut whose two sides differ by
    more than 1e-5 relative (``assignment_margin``, ``mining_margin``;
    the frameworks' cross-entropies agree to ~1e-6)."""
    port = net["port"].train()
    head = port.bbox_head
    assert isinstance(head, SSDHead)
    x = torch.from_numpy(net["images"])
    t = {k: torch.from_numpy(a) for k, a in net["targets"].items()}
    with torch.no_grad():
        outs = head(port.extract_feats(x))
    sizes = [tuple(c.shape[1:3]) for c in outs[0]]
    assert assignment_margin(head, t["hboxes"], t["gt_mask"], sizes) > 1e-5
    assert mining_margin(head, outs, t) > 1e-5
    port.zero_grad()
    got = port.loss(x, t)
    sum(got.values()).backward()
    assert set(got) == set(net["loss"]) == set(LOSSES)
    for k, r in net["loss"].items():
        g = float(got[k].detach())
        assert r > 0 and abs(g - r) <= 1e-5 * r, (k, g, r)
    ref = jax_to_state_dict({"params": net["grads"]})
    named = dict(port.named_parameters())
    assert set(named) == set(ref)
    for n, p in named.items():
        _close(p.grad, ref[n], 1e-4)


def test_get_bboxes_matches_jax(net):
    """``SSDHead.get_bboxes`` with the classifier spread against JAX
    ``SSD.predict``: the same valid slots and the same labels in the same
    order (0-based, where JAX's are 1-based; -1 empty in both), scores
    within 1e-5, polygons (hbbs) within 1e-4 px; the scale factor is not
    read. ``SingleStageDetector.predict`` gives the head's detections."""
    model = net["spread"].eval()
    x = torch.from_numpy(net["images"])
    ref = net["pred"]
    with torch.no_grad():
        outs = model.bbox_head(model.extract_feats(x))
        got = model.bbox_head.get_bboxes(outs, torch.full((2,), 7.0))
    assert set(got) == set(ref) == {"polys", "scores", "labels", "valid"}
    v = ref["valid"]
    assert v.sum(1).min() > 10
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.where(v, ref["labels"] - 1, -1))
    assert ref["labels"][v].min() >= 1 and (ref["labels"][~v] == -1).all()
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               atol=1e-5)
    np.testing.assert_allclose(got["polys"].numpy()[v], ref["polys"][v],
                               atol=1e-4)
    pred = model.predict(x)
    assert torch.equal(pred["labels"], got["labels"])
    assert torch.equal(pred["polys"], got["polys"])


def test_saved_jax_tree_loads(net, tmp_path):
    """A JAX SSD tree pickled as numpy arrays loads through
    ``load_jax_checkpoint`` / ``load_jax_variables`` with no name left
    over on either side: ``conv{s}_{j}``, ``l2norm/gamma``, ``fc6``,
    ``fc7``, the neck's ``extra{i}_reduce`` / ``extra{i}_conv`` and the
    head's ``cls_{i}`` / ``reg_{i}`` equal to the tree."""
    path = tmp_path / "ssd.pkl"
    with open(path, "wb") as f:
        pickle.dump(net["v"], f)
    port = reg.build_from_cfg(net["cfg"], reg.MODELS)
    load_jax_variables(port, load_jax_checkpoint(str(path)))
    sd = port.state_dict()
    p = net["v"]["params"]
    for part, name in (("backbone", "conv1_1"), ("backbone", "conv5_3"),
                       ("backbone", "fc6"), ("backbone", "fc7"),
                       ("neck", "extra0_reduce"), ("neck", "extra3_conv"),
                       ("bbox_head", "cls_0"), ("bbox_head", "reg_5")):
        k = p[f"_{part}"][name]
        np.testing.assert_array_equal(sd[f"{part}.{name}.weight"].numpy(),
                                      k["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{part}.{name}.bias"].numpy(),
                                      k["bias"])
    np.testing.assert_array_equal(sd["backbone.l2norm.gamma"].numpy(),
                                  p["_backbone"]["l2norm"]["gamma"])
    bad = copy.deepcopy(net["v"])
    bad["params"]["_neck"]["extra4_conv"] = bad["params"]["_neck"][
        "extra3_conv"]
    with pytest.raises(ValueError, match="extra4_conv"):
        load_jax_variables(reg.build_from_cfg(net["cfg"], reg.MODELS), bad)


def test_train_task_steps_match_jax(net):
    """``Runner.run`` over the rendered COCO images: each of its 2 steps'
    losses within 1e-5 relative of the JAX network's loss of the same
    batch at the same iterate of the JAX package's SGD (momentum 0.9,
    decay 1e-4, its optax chain on the JAX gradients), and every
    parameter after the 2 steps within 1e-5 of JAX's."""
    tasks = net["tasks"]
    hist = tasks["trainer"].history
    assert len(hist) == len(tasks["jax_losses"]) == 2
    head = tasks["trainer"].model.bbox_head
    sizes = [(12, 12), (6, 6), (3, 3), (2, 2), (2, 2), (2, 2)]
    for (_, t, _), rec, ref in zip(tasks["batches"], hist,
                                   tasks["jax_losses"]):
        assert assignment_margin(head, torch.as_tensor(t["hboxes"]),
                                 torch.as_tensor(t["gt_mask"]), sizes) > 1e-5
        for k in LOSSES:
            assert abs(rec[k] - ref[k]) <= 1e-5 * abs(ref[k]), (k, rec, ref)
    got = {k: v.detach().numpy()
           for k, v in tasks["trainer"].model.state_dict().items()}
    ref = tasks["jax_params"]
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-5, err_msg=k)


def test_test_task_matches_jax_predict(net):
    """``Runner.test`` on 2 rendered images (one batch) from the spread
    weights against JAX ``predict`` of the same batch: per image the same
    detections above the runner's 0.05, labels 1-based as the dataset's
    categories, scores within 1e-5, polygons within 1e-4 px."""
    tasks = net["tasks"]
    ref = tasks["jax_pred"]
    assert len(tasks["results"]) == 2
    for i, ((p, s, lab), meta) in enumerate(tasks["results"]):
        assert meta["img_size"] == (IMG, IMG)
        keep = ref["valid"][i] & (ref["scores"][i] > 0.05)
        assert keep.sum() > 5 and len(s) == keep.sum()
        np.testing.assert_array_equal(lab, ref["labels"][i][keep])
        np.testing.assert_allclose(s, ref["scores"][i][keep], atol=1e-5)
        np.testing.assert_allclose(p, ref["polys"][i][keep], atol=1e-4)


def test_val_on_ground_truth_gives_ap_1_per_class(tmp_path, monkeypatch):
    """``Runner.val`` on a rendered COCO val set (categories 3, 7 and 18,
    so labels 1-3, and a crowd box dropped) of images that are not
    square and not 96^2, so that the letterbox resizes and pads each,
    with the head's detections set to each sample's ground truth in the
    letterboxed frame the network sees (0-based labels, -1 empty):
    through ``postprocess_dense`` (1-based, back in the image's frame)
    and ``COCODataset.evaluate``, AP 1 for every class at every IoU
    threshold. A label off by one, or a box left in the letterboxed
    frame, would score 0."""
    img_dir, ann = render_coco(
        str(tmp_path / "val"), n=4, seed=5, objects=4,
        size=[(150, 100), (70, 110), (96, 60), (200, 200)])
    _use(dict(name="ssd_val", work_dir=str(tmp_path / "work"), seed=3,
              model=tiny_model(), optimizer=SGD,
              dataset=dict(train=None, test=None,
                           val=coco_section(img_dir, ann, max_gt=8))))
    runner = Runner(device="cpu")
    ds = runner.val_dataset
    truth = iter([ds[i][1] for i in range(len(ds))])
    assert all(t["letterbox"][1:] != (0, 0) for t in
               [ds[i][1] for i in range(3)])

    def gt_dets(self, outs, scale_factor=None):
        b = outs[0][0].shape[0]
        out = dict(polys=torch.zeros(b, 8, 8), scores=torch.zeros(b, 8),
                   labels=torch.full((b, 8), -1),
                   valid=torch.zeros(b, 8, dtype=torch.bool))
        for i in range(b):
            a = next(truth)
            n = len(a["labels"])
            out["polys"][i, :n] = B.hbb2poly(torch.from_numpy(a["hboxes"]))
            out["scores"][i, :n] = 0.9
            out["labels"][i, :n] = torch.from_numpy(a["labels"]).long() - 1
            out["valid"][i, :n] = True
        return out

    monkeypatch.setattr(SSDHead, "get_bboxes", gt_dets)
    aps = runner.val()
    assert sorted(set(np.concatenate([i["ann"]["labels"]
                                      for i in ds.img_infos]))) == [1, 2, 3]
    assert aps["per_class_ap50"] == [1.0, 1.0, 1.0]
    assert aps["eval/mAP"] == aps["eval/AP50"] == 1.0
    assert runner.val_aps == {"eval/mAP": 1.0, "eval/AP50": 1.0}


def test_the_jax_runners_val_cannot_evaluate_a_coco_dataset(tmp_path):
    """The JAX runner hands ``evaluate`` (detections, meta) pairs
    (``rs_detection_tpu/runner/runner.py:415``); the JAX
    ``COCODataset.evaluate`` unpacks three values an image and raises.
    The port's takes those pairs (``test_val_on_ground_truth_gives_ap_1_
    per_class``)."""
    img_dir, ann = render_coco(str(tmp_path), n=1)
    ds = jyolo.COCODataset(images_dir=img_dir, annotations_file=ann)
    det = (np.zeros((0, 8)), np.zeros(0), np.zeros(0, int))
    with pytest.raises(ValueError, match="unpack"):
        ds.evaluate([(det, {})])
