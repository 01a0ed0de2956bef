"""YOLOv5 in the port against the JAX package, CPU, f32: the narrow
network of ``tests/test_torch_yolo_cuda.py:tiny_model`` (width 0.125,
depth 0.33, 4 classes, 128^2) built by each framework's registry from one
config section, seeded JAX variables (perturbed) carried across by
``load_jax_variables``: the backbone's and the neck's levels, the head's
raw outputs and ``_decode_level``, each loss term and every gradient,
``get_bboxes`` with the objectness lifted, and the running statistics a
training step leaves. Then the port's runner serving the same weights:
``Runner.test`` against JAX ``predict``.

The JAX loss runs at batch 1 only: its gathers index the image by
``arange(b)[:, None]`` against [B, G, A] cells, which broadcasts only
where G equals B or one of them is 1 (pinned here; ROADMAP.md, Queue 3).
The port gathers each gt's own image. Its batch-2 loss is held to the
JAX losses of single images where one image of the pair has no ground
truth: the box and class terms are then twice the other image's, the
objectness term the sum of both. One JAX compile serves every
comparison (the losses, their gradient, the levels and ``predict`` at
one batch-1 shape)."""

import copy
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.flagship import normalize
from rs_detection_tpu_torch.models.networks.yolo import (RunningBatchNorm2d,
                                                         YOLOv5Head)
from rs_detection_tpu_torch.optims.optimizer import SGD
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_checkpoint,
                                                      load_jax_variables)
from PIL import Image
from test_torch_fcos_networks import NORM, one_thread, random_variables
from test_torch_yolo_cuda import nms_margin, tiny_inputs, tiny_model

LOSSES = ("box_loss", "obj_loss", "cls_loss")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def variables(jm, shape, seed=7, gain=1.3):
    """``random_variables`` (the head's kernels N(0, 0.01^2)) with the
    body's kernels times ``gain``: at N(0, 1 / fan_in) the SiLU body
    halves the signal a layer and the narrow network's outputs are nearly
    the same at every position (ties everywhere in the NMS); at 1.3 they
    keep their scale, at 2 they blow up."""
    v = random_variables(jm, shape, seed=seed, heads=("_head",))

    def scale(tree):
        return {k: scale(a) if isinstance(a, dict) else
                (a * gain).astype(np.float32) if k == "kernel" else a
                for k, a in tree.items()}

    p = v["params"]
    return dict(v, params=dict(p, _backbone=scale(p["_backbone"]),
                               _neck=scale(p["_neck"])))


def lift(v, kernel=2.4, bias=-3.0, seed=5):
    """The JAX tree with the head's kernels times ``kernel``, every
    level's objectness bias at ``bias`` and the class biases N(0, 1), so
    that a few dozen candidates' confidences pass 0.25 apart."""
    v = copy.deepcopy(v)
    rng = np.random.RandomState(seed)
    for i in range(3):
        out = v["params"]["_head"][f"out{i}"]
        out["kernel"] = (out["kernel"] * kernel).astype(np.float32)
        b = out["bias"].reshape(3, -1)
        b[:, 4] = bias
        b[:, 5:] = rng.randn(3, b.shape[1] - 5)
        v["params"]["_head"][f"out{i}"]["bias"] = b.reshape(-1).astype(
            np.float32)
    return v


def compile_run(jm):
    """One jitted function of (variables, lifted variables, one image,
    its targets): the backbone's and the neck's levels, the head's
    outputs and their decoding, the losses with the running statistics
    the train-mode loss leaves, the gradient, and ``predict`` of the
    lifted variables, as numpy."""
    def run(v, lv, images, t):
        def loss_fn(params):
            losses, stats = jm.apply(dict(v, params=params), images, t,
                                     method=jm.loss, mutable=["batch_stats"])
            return sum(losses.values()), (losses, stats)

        (_, (losses, stats)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(v["params"])
        def levels(m, i):
            base = m._backbone(i)
            feats = m._neck(base)
            return base, feats, m._head(feats)

        base, feats, raw = jm.apply(v, images, method=levels)
        dec = [jm.apply(v, r, method=lambda m, p, lvl=lvl:
                        m._head._decode_level(p, lvl))
               for lvl, r in enumerate(raw)]
        return dict(base=base, feats=feats, raw=raw, dec=dec, losses=losses,
                    stats=stats, grads=grads,
                    pred=jm.apply(lv, images, {}, method=jm.predict))

    fn = jax.jit(run)
    return lambda *a: jax.tree_util.tree_map(np.asarray, fn(*a))


def jax_targets(t, i, empty=False):
    """Image ``i``'s targets as JAX reads them (no ground truth at all with
    ``empty``)."""
    mask = np.asarray(t["gt_mask"][i:i + 1], bool)
    return dict(hboxes=np.asarray(t["hboxes"][i:i + 1], np.float32),
                gt_mask=mask & (not empty),
                labels=np.asarray(t["labels"][i:i + 1], np.int32))


def _use(cfg):
    c = get_cfg()
    c.clear()
    c.update(copy.deepcopy(cfg))


def serve_task(root, lv, run, v, tiles, jt):
    """The port's test task over ``tiles`` written as PNGs (an
    ``ImageDataset``, normalized, batch 1) from the lifted weights; JAX
    ``predict`` of each tile (``run`` at its one shape: the targets ``jt``
    of the fixture's first image, which ``predict`` does not read)."""
    os.makedirs(root / "tiles")
    for i, tile in enumerate(tiles.numpy()):
        Image.fromarray(tile).save(root / "tiles" / f"tile_{i}.png")
    with open(root / "lifted.pkl", "wb") as f:
        pickle.dump(lv, f)
    section = dict(type="ImageDataset", images_dir=str(root / "tiles"),
                   dataset_type="DOTA", batch_size=1, transforms=[NORM])
    _use(dict(name="yolo_test", work_dir=str(root / "work"), seed=3,
              model=tiny_model(ema=False),
              pretrained_weights=str(root / "lifted.pkl"),
              dataset=dict(train=None, val=None, test=section)))
    tester = Runner(device="cpu")
    results = tester.test()
    preds, margin = [], 1.0
    for images, _, _ in tester.test_dataset.batches():
        preds.append(run(v, lv, images, jt)["pred"])
        with torch.no_grad():
            x = torch.from_numpy(images)
            margin = min(margin, nms_margin(tester.model.bbox_head,
                                            tester.model.bbox_head(
                                                tester.model.extract_feats(x))))
    return results, preds, margin


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    tiles, t = tiny_inputs()
    images = normalize(tiles).numpy()
    cfg = tiny_model(ema=False)
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    v = variables(jm, (1,) + images.shape[1:])
    lv = lift(v)
    run = compile_run(jm)
    ref = [run(v, lv, images[i:i + 1], jax_targets(t, i)) for i in range(2)]
    empty = [run(v, lv, images[i:i + 1], jax_targets(t, i, empty=True))
             for i in range(2)]
    return dict(
        cfg=cfg, jm=jm, images=images, targets=t, v=v, ref=ref, empty=empty,
        port=load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v),
        lifted=load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), lv),
        task=serve_task(tmp_path_factory.mktemp("yolo_test"), lv, run, v,
                        tiles, jax_targets(t, 0)))


def _close(got, ref, rel):
    """``got`` within ``rel`` of ``ref``'s largest entry."""
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def _one(net, i, empty=False):
    t = net["targets"]
    mask = t["gt_mask"][i:i + 1] & (not empty)
    return (torch.from_numpy(net["images"][i:i + 1]),
            dict(hboxes=t["hboxes"][i:i + 1], gt_mask=mask,
                 labels=t["labels"][i:i + 1]))


def test_backbone_neck_and_head_outputs_match_jax(net):
    """Per image: the backbone's three levels (16^2, 8^2, 4^2), the
    neck's three and the head's raw [1, H, W, 3 x 9] outputs within 1e-5
    of their largest entry, NHWC; ``_decode_level``'s centers and sizes
    (px) within 1e-4 of their largest, the logits within 1e-5."""
    port = net["port"].eval()
    for i, ref in enumerate(net["ref"]):
        x, _ = _one(net, i)
        with torch.no_grad():
            base = port.backbone(x)
            feats = port.neck(base)
            raw = port.bbox_head(feats)
        assert [tuple(f.shape[1:3]) for f in base] == [(16, 16), (8, 8),
                                                       (4, 4)]
        for got, want in zip(base, ref["base"]):
            _close(got, want, 1e-5)
        for got, want in zip(feats, ref["feats"]):
            _close(got, want, 1e-5)
        for lvl, (got, want) in enumerate(zip(raw, ref["raw"])):
            assert got.shape[-1] == 3 * (5 + 4)
            _close(got, want, 1e-5)
            dec = port.bbox_head._decode_level(got, lvl)
            for g, w, tol in zip(dec, ref["dec"][lvl], (1e-4, 1e-4, 1e-5,
                                                        1e-5)):
                _close(g, w, tol)


def test_losses_and_gradient_match_jax(net):
    """Each image alone (the batch JAX can run): the three loss terms
    within 1e-5 relative, all above 0, and every parameter's gradient
    within 1e-4 of its largest entry, in f32 (the boxes' aspect ratios
    stay under 6, where CIoU's arctan term is well conditioned)."""
    port = net["port"].train()
    for i, ref in enumerate(net["ref"]):
        x, t = _one(net, i)
        port.zero_grad()
        got = port.loss(x, t)
        sum(got.values()).backward()
        assert set(got) == set(ref["losses"]) == set(LOSSES)
        for k, r in ref["losses"].items():
            g = float(got[k].detach())
            assert r > 0 and abs(g - r) <= 1e-5 * r, (i, k, g, r)
        grads = jax_to_state_dict({"params": ref["grads"]})
        named = dict(port.named_parameters())
        assert set(named) == set(grads)
        for n, p in named.items():
            _close(p.grad, grads[n], 1e-4)


@pytest.mark.parametrize("full", [0, 1])
def test_batch_of_two_composes_from_single_images(net, full):
    """The port's loss of both images at once, image ``full``'s ground
    truths kept and the other's masked: box and class terms twice the
    JAX terms of image ``full`` alone (n_pos counts the batch, the gains
    take the batch size), the objectness term the sum of the two images'
    JAX terms, within 1e-5 relative. A gather from the wrong image would
    miss by far more."""
    t = net["targets"]
    mask = t["gt_mask"].clone()
    mask[1 - full] = False
    port = net["port"].train()
    with torch.no_grad():
        got = port.loss(torch.from_numpy(net["images"]),
                        dict(t, gt_mask=mask))
    ref = net["ref"][full]["losses"]
    other = net["empty"][1 - full]["losses"]
    want = dict(box_loss=2 * ref["box_loss"], cls_loss=2 * ref["cls_loss"],
                obj_loss=ref["obj_loss"] + other["obj_loss"])
    for k, w in want.items():
        assert abs(float(got[k]) - w) <= 1e-5 * w, (k, float(got[k]), w)
    assert net["empty"][1 - full]["losses"]["box_loss"] == 0.0


def test_the_jax_loss_cannot_run_a_batch_of_two(net):
    """The JAX ``YOLOv5Head.loss`` gathers at ``p[arange(b)[:, None],
    cy, cx, a]`` with cy [B, G, A]: at batch 2 and 6 slots the shapes do
    not broadcast (``rs_detection_tpu/models/networks/yolo.py:242-247``).
    The port runs any batch (above)."""
    t = net["targets"]
    jt = dict(hboxes=t["hboxes"].numpy(), gt_mask=t["gt_mask"].numpy(),
              labels=t["labels"].numpy())
    jm = net["jm"]
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jax.eval_shape(lambda v, i, tt: jm.apply(v, i, tt, method=jm.loss),
                       net["v"], net["images"], jt)


def test_batchnorm_never_moves(net):
    """Quirk 1: the JAX train-mode loss applied with ``mutable=
    ["batch_stats"]`` gives back the statistics it was given, bit for
    bit; the port's ``RunningBatchNorm2d`` normalizes with its running
    statistics in train mode too, and an SGD step leaves them as they
    were (only parameters move)."""
    ref_stats = jax_to_state_dict(dict(batch_stats=net["ref"][0]["stats"][
        "batch_stats"]))
    given = jax_to_state_dict(dict(batch_stats=net["v"]["batch_stats"]))
    assert set(ref_stats) == set(given) and len(given) == 2 * 57
    for k in given:
        np.testing.assert_array_equal(ref_stats[k], given[k])
    model = reg.build_from_cfg(net["cfg"], reg.MODELS)
    load_jax_variables(model, net["v"])
    bns = [m for m in model.modules() if isinstance(m, RunningBatchNorm2d)]
    assert len(bns) == 57
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    opt = SGD(model.named_parameters(), lr=0.1, momentum=0.9)
    x, t = _one(net, 0)
    model.train()
    sum(model.loss(x, t).values()).backward()
    opt.step()
    after = model.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert not torch.equal(after["backbone.stem_bn.weight"],
                           torch.from_numpy(net["v"]["params"]["_backbone"][
                               "stem_bn"]["scale"]))


def test_get_bboxes_matches_jax(net):
    """``YOLOv5Head.get_bboxes`` with the objectness lifted against JAX
    ``YOLO.predict``, per image: the same valid slots (more than 10) and
    the same labels in the same order (JAX's less 1: the port's are
    0-based, JAX's 1-based; -1 empty in both), scores within 1e-5,
    polygons (hbbs) within 1e-3 px, on candidates whose confidences,
    their order and the same-class IoUs stand 1e-5 from every threshold
    and tie (``nms_margin``)."""
    model = net["lifted"].eval()
    for i, ref in enumerate(net["ref"]):
        x, _ = _one(net, i)
        want = ref["pred"]
        with torch.no_grad():
            raw = model.bbox_head(model.extract_feats(x))
            got = model.bbox_head.get_bboxes(raw, torch.full((1,), 7.0))
        assert nms_margin(model.bbox_head, raw) > 1e-5
        v = want["valid"]
        assert v.sum() > 10
        np.testing.assert_array_equal(got["valid"].numpy(), v)
        assert want["labels"][v].min() >= 1 and (want["labels"][~v] == -1
                                                 ).all()
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.where(v, want["labels"] - 1, -1))
        np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                                   atol=1e-5)
        np.testing.assert_allclose(got["polys"].numpy()[v], want["polys"][v],
                                   atol=1e-3)
        pred = model.predict(x)
        assert torch.equal(pred["labels"], got["labels"])


def test_test_task_matches_jax_predict(net):
    """``Runner.test`` over the 2 tiles written as PNGs at batch 1 from the
    lifted weights against JAX ``predict`` of each tile: the detections
    above the runner's 0.05, labels 1-based as JAX's, scores within 1e-5,
    polygons within 1e-3 px, on a margin (``nms_margin``). The
    letterboxed ``YoloDataset`` path is ``test_torch_yolo_runner.py``'s."""
    results, preds, margin = net["task"]
    assert margin > 1e-5
    assert len(results) == len(preds) == 2
    for ((p, s, lab), meta), ref in zip(results, preds):
        keep = ref["valid"][0] & (ref["scores"][0] > 0.05)
        assert keep.sum() > 5 and len(s) == keep.sum()
        np.testing.assert_array_equal(lab, ref["labels"][0][keep])
        np.testing.assert_allclose(s, ref["scores"][0][keep], atol=1e-5)
        np.testing.assert_allclose(p, ref["polys"][0][keep], atol=1e-3)


def test_saved_jax_tree_loads(net, tmp_path):
    """A JAX YOLO tree pickled as numpy arrays loads through
    ``load_jax_checkpoint`` / ``load_jax_variables`` with no name left
    over on either side: ``_backbone`` / ``_neck`` / ``_head`` as
    ``backbone`` / ``neck`` / ``bbox_head``; ``stem_conv`` (6x6, HWIO ->
    OIHW), ``stem_bn`` (scale, mean, var), ``c3_1.m0.cv1_conv``,
    ``sppf.cv2_conv``, ``lat5``, ``td4``, ``bu6`` and the head's
    ``out{i}`` with their biases equal to the tree."""
    path = tmp_path / "yolo.pkl"
    with open(path, "wb") as f:
        pickle.dump(net["v"], f)
    port = reg.build_from_cfg(net["cfg"], reg.MODELS)
    load_jax_variables(port, load_jax_checkpoint(str(path)))
    sd = port.state_dict()
    p, bs = net["v"]["params"], net["v"]["batch_stats"]
    for part, path_ in (("backbone", ("stem_conv",)),
                        ("backbone", ("c3_1", "m0", "cv1_conv")),
                        ("backbone", ("sppf", "cv2_conv")),
                        ("neck", ("lat5_conv",)),
                        ("neck", ("td4", "cv3_conv")),
                        ("neck", ("bu6", "m0", "cv2_conv"))):
        node = p["_" + part]
        for k in path_:
            node = node[k]
        np.testing.assert_array_equal(
            sd[".".join((part,) + path_) + ".weight"].numpy(),
            node["kernel"].transpose(3, 2, 0, 1))
    assert sd["backbone.stem_conv.weight"].shape[2:] == (6, 6)
    np.testing.assert_array_equal(sd["backbone.stem_bn.running_var"].numpy(),
                                  bs["_backbone"]["stem_bn"]["var"])
    np.testing.assert_array_equal(sd["backbone.stem_bn.weight"].numpy(),
                                  p["_backbone"]["stem_bn"]["scale"])
    for i in range(3):
        out = p["_head"][f"out{i}"]
        np.testing.assert_array_equal(sd[f"bbox_head.out{i}.bias"].numpy(),
                                      out["bias"])
        np.testing.assert_array_equal(
            sd[f"bbox_head.out{i}.weight"].numpy(),
            out["kernel"].transpose(3, 2, 0, 1))
    assert isinstance(port.bbox_head, YOLOv5Head)
    bad = copy.deepcopy(net["v"])
    del bad["params"]["_neck"]["bu6"]
    with pytest.raises(ValueError, match="bu6"):
        load_jax_variables(reg.build_from_cfg(net["cfg"], reg.MODELS), bad)
