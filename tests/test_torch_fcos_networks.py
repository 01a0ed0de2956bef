"""FCOS in the port against the JAX package, CPU, f32: the tiny network
of ``tests/test_torch_fcos_cuda.py:tiny_model`` (``tests/test_golden_
loss.py:build_fcos``'s network with running statistics) built by each
framework's registry from one config, seeded JAX variables (perturbed:
biases, norms, the per-level ``scales`` and ``scale_theta_p``) carried
across by ``load_jax_variables``: the three training losses and
``predict`` (the classifier spread so that the random
head detects) on seeded tiles, and a saved JAX tree loading into every
parameter. Then the port's runner from the same weights: ``Runner.run``
(the train task of ``run_net``) takes 2 SGD steps on the rendered tiles
of ``tests/test_map_pipeline.py:render_dataset``, its first step's
losses against the JAX network's ``loss`` of the same batch, and
``Runner.test`` (the test task) on two tiles against the JAX network's
``predict`` read by the port's ``postprocess_dense`` (the JAX runner's
own test task cannot serve a single-stage network, ROADMAP.md, Queue 3).
One JAX compile serves every comparison: one shape of batch throughout
(128^2 tiles, the widths of ``tests/test_golden_loss.py:169-190``).

The poly-IoU loss's gradient is held to JAX's in
``tests/test_torch_fcos_ops.py``."""

import contextlib
import copy
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.flagship import normalize
from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.models.roi_heads.fcos_head import FCOSHead
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (load_jax_checkpoint,
                                                      load_jax_variables)
from test_map_pipeline import render_dataset
from test_torch_fcos_cuda import target_margin, tiny_inputs, tiny_model
from test_torch_port_slice import perturb

LOSSES = ("loss_cls", "loss_bbox", "loss_centerness")
IMG = 128
NORM = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_bgr=False)
RESIZE = dict(type="RotatedResize", min_size=IMG, max_size=IMG)


def random_variables(jm, shape, seed, heads=()):
    """The JAX network's variables without compiling its init: the tree
    of ``jax.eval_shape``, kernels drawn N(0, 1 / fan_in) (flax's default
    ``lecun_normal``; those under the top names ``heads`` N(0, 0.01^2),
    the JAX heads' own initializer), scales and variances 1, means and
    biases 0, a learnable scalar or vector 1; then ``perturb``."""
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.zeros(shape)))
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            std = 0.01 if path[1].key in heads else \
                1.0 / np.sqrt(np.prod(s.shape[:-1]))
            return (rng.randn(*s.shape) * std).astype(np.float32)
        if name in ("mean", "bias"):
            return np.zeros(s.shape, np.float32)
        return np.ones(s.shape, np.float32)

    return perturb(jax.tree_util.tree_map_with_path(leaf, tree), seed)


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread for the block, then the count it had:
    the fast tier runs six test processes on the host's cores, and
    torch's spinning worker threads starve the others (a module of these
    tests took 3x as long with all of them)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


def jax_targets(t):
    """The three target arrays the JAX losses read, in fixed dtypes (one
    trace for every batch)."""
    return dict(rboxes=np.asarray(t["rboxes"], np.float32),
                gt_mask=np.asarray(t["gt_mask"], bool),
                labels=np.asarray(t["labels"], np.int32))


def compile_run(jm):
    """One jitted function of (variables for the loss, variables for
    ``predict``, images, targets, scale factors): the losses and
    ``predict``, as numpy."""
    def run(v, sv, i, jt, sf):
        return (jm.apply(v, i, jt, method=jm.loss),
                jm.apply(sv, i, {"scale_factor": sf}, method=jm.predict))

    fn = jax.jit(run)
    return lambda *a: jax.tree_util.tree_map(np.asarray, fn(*a))


def spread_classifier(v, head="_bbox_head", name="conv_cls"):
    """The classifier spread (kernel x 60, biases N(0, 1))."""
    v = copy.deepcopy(v)
    cls = v["params"][head][name]
    cls["kernel"] = cls["kernel"] * 60.0
    cls["bias"] = np.random.RandomState(8).randn(
        *cls["bias"].shape).astype(np.float32)
    return v


def runner_cfg(name, model, ds, work_dir, weights, test_dir):
    """A tiny config's train task over the rendered tiles of ``ds`` (2 SGD
    steps at batch 2, 6 slots) and test task over ``test_dir``, from the
    JAX ``weights``, at 128^2."""
    return dict(
        name=name, work_dir=work_dir, seed=3, max_epoch=10, max_iter=2,
        log_interval=1, checkpoint_interval=1, model=model,
        pretrained_weights=weights,
        dataset=dict(
            train=dict(type="DOTADataset", dataset_dir=ds, batch_size=2,
                       max_gt=6, shuffle=False, filter_empty_gt=False,
                       transforms=[RESIZE, NORM]),
            test=dict(type="ImageDataset", images_dir=test_dir,
                      dataset_type="DOTA", batch_size=2,
                      transforms=[RESIZE, NORM])),
        optimizer=dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4,
                       grad_clip=dict(max_norm=35)),
        scheduler=dict(type="StepLR", warmup="linear", warmup_iters=4,
                       warmup_ratio=0.25, milestones=[8]))


def _use(cfg):
    c = get_cfg()
    c.clear()
    c.update(copy.deepcopy(cfg))


def runner_tasks(root, name, model, weights, run, seed=0):
    """Render 4 tiles (``render_dataset`` with ``seed``), write
    ``weights``, run the port's train task (``runner_cfg``), then its
    test task on tiles 0 and 1; ``run`` (``compile_run``'s) gives JAX's
    loss of the train task's first batch and ``predict`` of each test
    batch. Returns a dict: the train runner, its first batch, JAX's loss
    of it, the test results and per test batch (metas, JAX predict)."""
    ds = render_dataset(str(root / "ds"), size=IMG, seed=seed)
    tiles = root / "tiles"
    os.makedirs(tiles)
    for f in ("tile_0.png", "tile_1.png"):
        shutil.copy(os.path.join(ds, "images", f), tiles)
    with open(root / "weights.pkl", "wb") as f:
        pickle.dump(weights, f)
    cfg = runner_cfg(name, model, ds, str(root / "train"),
                     str(root / "weights.pkl"), str(tiles))
    _use(cfg)
    trainer = Runner(device="cpu")
    batch = next(iter(trainer.train_dataset.batches()))
    trainer.run()
    _use(dict(cfg, work_dir=str(root / "test")))
    tester = Runner(device="cpu")
    tester.test()
    with open(root / "test" / "test" / "test_0.pkl", "rb") as f:
        results = pickle.load(f)
    jt = jax_targets(batch[1])
    ones = np.ones(2, np.float32)
    return dict(
        trainer=trainer, batch=batch, results=results,
        train_loss=run(weights, weights, batch[0], jt, ones)[0],
        test_refs=[(metas, run(weights, weights, imgs, jt, np.asarray(
            tt["scale_factor"], np.float32))[1])
            for imgs, tt, metas in tester.test_dataset.batches()])


def assert_same_detections(got, ref, score_atol=5e-5, poly_atol=1e-3):
    """The same valid slots; per image every detection of ``ref`` matched
    by one of ``got`` with its label, its score within ``score_atol`` and
    its polygon within ``poly_atol`` px. Two detections whose scores lie
    within f32 noise may swap slots between the packages."""
    valid = ref["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    for i in range(valid.shape[0]):
        g = [(int(got["labels"][i, j]), float(got["scores"][i, j]),
              got["polys"][i, j].numpy()) for j in np.nonzero(valid[i])[0]]
        for j in np.nonzero(valid[i])[0]:
            hit = [k for k, (lab, sc, p) in enumerate(g)
                   if lab == ref["labels"][i, j]
                   and abs(sc - ref["scores"][i, j]) <= score_atol
                   and np.abs(p - ref["polys"][i, j]).max() <= poly_atol]
            assert hit, (i, j)
            g.pop(hit[0])


def assert_test_task_matches(tasks):
    """``Runner.test``'s results against JAX ``predict`` of the same
    batches read by ``postprocess_dense``: per tile the same detections,
    labels and scores (to 1e-5), polygons to 1e-3 px, more than 2 a
    tile."""
    results, n = tasks["results"], 0
    for metas, out in tasks["test_refs"]:
        live = [m for m in metas if m]
        for (p, s, lab), meta, ((gp, gs, glab), gmeta) in zip(
                Runner.postprocess_dense(out, metas), live,
                results[n:n + len(live)]):
            assert gmeta["filename"] == meta["filename"]
            order, gorder = np.lexsort((lab, -s)), np.lexsort((glab, -gs))
            np.testing.assert_array_equal(glab[gorder], lab[order])
            np.testing.assert_allclose(gs[gorder], s[order], atol=1e-5)
            np.testing.assert_allclose(gp[gorder], p[order], atol=1e-3)
        n += len(live)
    assert n == len(results) == 2
    assert min(len(s) for (_, s, _), _ in results) > 2


def assert_first_step_matches(tasks, lrs=(0.0025, 0.004375)):
    """The runner's first step's losses within 1e-5 relative of JAX's
    loss of the same batch; two steps recorded, finite, at the warm-up's
    rates."""
    hist = tasks["trainer"].history
    assert len(hist) == 2
    for k, r in tasks["train_loss"].items():
        assert abs(hist[0][k] - r) <= 1e-5 * abs(r), (k, hist[0][k], r)
    assert all(np.isfinite(v) for rec in hist for k, v in rec.items()
               if "loss" in k)
    np.testing.assert_allclose([r["lr"] for r in hist], lrs)


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """The JAX network with seeded variables and the port's with them;
    JAX's losses and, with the classifier spread, ``predict`` on seeded
    tiles; the port's runner tasks from the spread
    weights (the config's ``roi_heads`` key) beside JAX's loss and
    ``predict`` of their batches."""
    # a seed and offset whose targets stand 1e-3 px from every threshold
    tiles, t = tiny_inputs(seed=8, img=IMG, axis_aligned=False, offset=0.37)
    images = normalize(tiles).numpy()
    targets = jax_targets(t)
    cfg = tiny_model()
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    v = random_variables(jm, images.shape, seed=7)
    head = v["params"]["_bbox_head"]
    head["scales"] = np.array([1.1, 0.9, 1.2, 0.8, 1.05], np.float32)
    head["scale_theta_p"] = np.array(0.7, np.float32)
    spread = spread_classifier(v)
    run = compile_run(jm)
    loss, pred = run(v, spread, images, targets, np.ones(2, np.float32))
    model = tiny_model()
    model["roi_heads"] = model.pop("bbox_head")
    tasks = runner_tasks(tmp_path_factory.mktemp("fcos_runner"),
                         "fcos_runner", model, spread, run)
    return dict(cfg=cfg, images=images, targets=targets, v=v, loss=loss,
                pred=pred, tasks=tasks,
                port=load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS),
                                        v),
                spread=load_jax_variables(
                    reg.build_from_cfg(cfg, reg.MODELS), spread))


def test_loss_matches_jax(net):
    """The focal, poly-IoU and centerness losses within 1e-5 relative,
    all above 0, on boxes whose targets stand at least 1e-3 px from every
    threshold (``target_margin``): the head's five levels of logits,
    scaled distances, angles and centerness through the dense targets."""
    port = net["port"].train()
    assert isinstance(port.bbox_head, FCOSHead)
    head = port.bbox_head
    sizes = [(IMG // s, IMG // s) for s in head.strides]
    points, strides, _ = head.level_tensors(sizes, "cpu")
    assert target_margin(head, points, strides,
                         torch.from_numpy(net["targets"]["rboxes"]),
                         torch.from_numpy(net["targets"]["gt_mask"])) > 1e-3
    got = port.loss(torch.from_numpy(net["images"]),
                    {k: torch.from_numpy(x)
                     for k, x in net["targets"].items()})
    assert set(got) == set(net["loss"]) == set(LOSSES)
    for k, r in net["loss"].items():
        g = float(got[k].detach())
        assert r > 0 and abs(g - r) <= 1e-5 * r, (k, g, r)


def test_predict_matches_jax(net):
    """``predict`` with the classifier spread: the same valid slots, and
    the same detections (labels, scores to 5e-5, polygons to 1e-3 px;
    ``assert_same_detections``), with detections in both images."""
    ref = net["pred"]
    got = net["spread"].eval().predict(torch.from_numpy(net["images"]))
    assert ref["valid"].sum(1).min() > 2
    assert_same_detections(got, ref)


def test_saved_jax_tree_loads(net, tmp_path):
    """A JAX FCOS tree pickled as numpy arrays loads through
    ``load_jax_checkpoint`` / ``load_jax_variables`` with no name left
    over on either side: the towers, their GroupNorms (``scale`` ->
    ``weight``), the four output convs, ``scales`` and the 0-d
    ``scale_theta_p`` equal to the tree."""
    path = tmp_path / "fcos.pkl"
    with open(path, "wb") as f:
        pickle.dump(net["v"], f)
    port = reg.build_from_cfg(net["cfg"], reg.MODELS)
    load_jax_variables(port, load_jax_checkpoint(str(path)))
    sd = port.state_dict()
    head = net["v"]["params"]["_bbox_head"]
    for name in ("cls_0", "reg_1", "conv_cls", "conv_reg", "conv_theta",
                 "conv_centerness"):
        np.testing.assert_array_equal(
            sd[f"bbox_head.{name}.weight"].numpy(),
            head[name]["kernel"].transpose(3, 2, 0, 1))
    for name in ("cls_gn_0", "reg_gn_1"):
        np.testing.assert_array_equal(sd[f"bbox_head.{name}.weight"].numpy(),
                                      head[name]["scale"])
    np.testing.assert_array_equal(sd["bbox_head.scales"].numpy(),
                                  head["scales"])
    assert sd["bbox_head.scale_theta_p"].shape == ()
    assert sd["bbox_head.scale_theta_p"].item() == pytest.approx(0.7)
    assert "bias" not in head["cls_0"] and port.bbox_head.cls_0.bias is None


def test_train_task_first_step_losses_match_jax(net):
    """``Runner.run``'s first step: its three losses within 1e-5
    relative of JAX's ``loss`` of the same batch from the same weights,
    on targets 1e-3 px from every threshold (``assert_first_step_
    matches``)."""
    tasks = net["tasks"]
    targets = tasks["batch"][1]
    head = tasks["trainer"].model.bbox_head
    sizes = [(IMG // s, IMG // s) for s in head.strides]
    points, strides, _ = head.level_tensors(sizes, "cpu")
    assert target_margin(head, points, strides,
                         torch.as_tensor(targets["rboxes"]),
                         torch.as_tensor(targets["gt_mask"]).bool()) > 1e-3
    assert_first_step_matches(tasks)


def test_test_task_matches_jax_predict(net):
    """``Runner.test`` on two tiles (one batch) against JAX ``predict``
    of the same batch (``assert_test_task_matches``)."""
    assert_test_task_matches(net["tasks"])
