"""The port's runner on a tiny S2ANet config against the JAX runner, CPU,
f32: ``Runner.run`` (the train task of ``run_net``) for 4 SGD steps on
the 4 rendered tiles of ``tests/test_map_pipeline.py:render_dataset``
from the same weights (the JAX init, perturbed), losses and parameters;
then ``Runner.test`` (the test task) over the same tiles, against the
JAX network's ``predict`` from the same weights. The JAX runner's own
test task cannot serve S2ANet: its ``postprocess_dense`` reads a score a
class, and the single-stage heads give one score a detection with its
label (ROADMAP.md, Queue 3); the port reads both forms."""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.runner.runner as jrunner
from rs_detection_tpu.config import get_cfg as jget_cfg
from rs_detection_tpu.parallel.train_step import (create_train_state,
                                                  make_train_step)
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.utils.jax_weights import jax_to_state_dict
from test_map_pipeline import render_dataset
from test_torch_port_slice import perturb
from torch_one_thread import _one_thread  # noqa: F401

NORM = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_bgr=False)
RESIZE = dict(type="RotatedResize", min_size=128, max_size=128)
# per step: warmup 0.25 -> 1 over 4 iterations
WANT_LRS = [0.01 * (0.25 + 0.75 * i / 4) for i in range(4)]


def s2anet_cfg(ds, work_dir, max_iter, **extra):
    """A tiny S2ANet as a zoo config writes it: Resnet18 with the zoo's
    freezing, a 32-wide FPN from C3 with ``on_input`` extra convs, the
    head with the zoo's anchors and thresholds and 2 classes; the
    rendered tiles to train on (batch 2, 8 slots) and to test."""
    cfg = dict(
        name="s2anet_runner", work_dir=work_dir, seed=3, max_epoch=10,
        max_iter=max_iter, log_interval=1, checkpoint_interval=1,
        model=dict(
            type="S2ANet",
            backbone=dict(type="Resnet18", frozen_stages=1, norm_eval=True),
            neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                      out_channels=32, start_level=1, num_outs=5,
                      add_extra_convs="on_input"),
            bbox_head=dict(type="S2ANetHead", num_classes=3, in_channels=32,
                           feat_channels=32, nms_pre=64, max_per_img=32,
                           test_cfg=dict(nms=dict(iou_thr=0.1),
                                         score_thr=0.05))),
        dataset=dict(
            train=dict(type="DOTADataset", dataset_dir=ds, batch_size=2,
                       max_gt=8, shuffle=False, filter_empty_gt=False,
                       transforms=[RESIZE, NORM]),
            test=dict(type="ImageDataset",
                      images_dir=os.path.join(ds, "images"),
                      dataset_type="DOTA", batch_size=2,
                      transforms=[RESIZE, NORM])),
        optimizer=dict(type="SGD", lr=0.01, momentum=0.9,
                       grad_clip=dict(max_norm=35)),
        scheduler=dict(type="StepLR", warmup="linear", warmup_iters=4,
                       warmup_ratio=0.25, milestones=[8]))
    cfg.update(extra)
    return cfg


def _use(getter, cfg):
    c = getter()
    c.clear()
    c.update(copy.deepcopy(cfg))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The JAX runner's 4 steps and the port's from the same weights; a
    second weights file with the ODM classifier spread (so that the
    random head detects) for the test task."""
    root = tmp_path_factory.mktemp("s2anet_runner")
    ds = render_dataset(str(root / "ds"))
    mp = pytest.MonkeyPatch()
    records = []
    try:
        _use(jget_cfg, s2anet_cfg(ds, str(root / "jax"), max_iter=4))
        jr = jrunner.Runner()
        images, targets, _ = next(iter(jr.train_dataset.batches()))
        weights = perturb(jax.jit(lambda i, t: jr.model.init(
            {"params": jax.random.PRNGKey(3)}, i, t))(
            jnp.asarray(images[:1]),
            {k: jnp.asarray(v[:1]) for k, v in targets.items()}), seed=7)
        with open(root / "weights.pkl", "wb") as f:
            pickle.dump(weights, f)
        lifted = copy.deepcopy(weights)
        head = lifted["params"]["_bbox_head"]["odm_cls_out"]
        head["kernel"] = head["kernel"] * 60.0
        head["bias"] = np.random.RandomState(8).randn(2).astype(np.float32)
        with open(root / "lifted.pkl", "wb") as f:
            pickle.dump(lifted, f)
        jr.state = jax.device_put(create_train_state(
            jr.model, jax.tree_util.tree_map(jnp.asarray, weights), jr.tx),
            jax.devices()[0])
        jr._train_step = make_train_step(jr.model, jr.tx, mesh=jr.mesh)
        log = jr.logger.log
        mp.setattr(jr.logger, "log", lambda d: (records.append(d), log(d)))
        while not jr.finish:
            jr.train()
        ref = jax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                       jr._variables()))
        jmodel = jr.model
    finally:
        mp.undo()
    _use(get_cfg, s2anet_cfg(ds, str(root / "port"), max_iter=4,
                             pretrained_weights=str(root / "weights.pkl")))
    port = Runner(device="cpu")
    port.run()
    return dict(ds=ds, root=root, jax_records=records, jax_params=ref,
                start=jax_to_state_dict(weights), port=port, jmodel=jmodel,
                lifted=lifted)


def test_train_task_losses_and_rates_match_jax(trained):
    """Each step's rate exactly, its four losses to 1e-3 relative (the
    zoo's freezing: the norms run on their statistics), both bbox losses
    above 0."""
    got, ref = trained["port"].history, trained["jax_records"]
    assert len(got) == len(ref) == 4
    np.testing.assert_allclose([r["lr"] for r in got], WANT_LRS, rtol=1e-12)
    for g, r in zip(got, ref):
        for k, v in r.items():
            if "loss" in k:
                assert abs(g[k] - v) <= 1e-3 * max(abs(v), 0.1), (k, g[k], v)
        assert r["loss_fam_bbox"] > 0 and r["loss_odm_bbox"] > 0


def test_train_task_parameters_match_jax(trained):
    """Each tensor within 1e-6 plus 3% of the largest distance its 4 JAX
    steps moved it (``tests/test_torch_resnet_runner.py``'s bound); the
    frozen stem and layer1 and the running statistics where they were."""
    got = {k: v.detach().numpy()
           for k, v in trained["port"].model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    ref, start = trained["jax_params"], trained["start"]
    assert set(got) == set(ref)
    for k, r in ref.items():
        d = np.abs(got[k] - r).max()
        moved = np.abs(r - start[k]).max()
        assert d <= 1e-6 + 0.03 * moved, (k, d, moved)


def test_test_task_matches_jax_predict(trained, tmp_path):
    """``Runner.test`` from the spread weights against the JAX network's
    ``predict`` of the same batches, read by the port's
    ``postprocess_dense``: per tile the same detections, labels and
    scores (to 1e-5), polygons to 1e-3 px. The JAX runner's own
    ``postprocess_dense`` raises on those outputs."""
    root = trained["root"]
    _use(get_cfg, s2anet_cfg(trained["ds"], str(tmp_path / "test"),
                             max_iter=4,
                             pretrained_weights=str(root / "lifted.pkl")))
    tester = Runner(device="cpu")
    tester.test()
    with open(tmp_path / "test" / "test" / "test_0.pkl", "rb") as f:
        results = pickle.load(f)
    jm = trained["jmodel"]
    lifted = jax.tree_util.tree_map(jnp.asarray, trained["lifted"])
    predict = jax.jit(lambda v, i: jm.apply(v, i, method=jm.predict))
    n = 0
    for images, _, metas in tester.test_dataset.batches():
        out = jax.tree_util.tree_map(np.asarray,
                                     predict(lifted, jnp.asarray(images)))
        with pytest.raises(IndexError):
            jrunner.Runner.postprocess_dense(out, metas)
        live = [m for m in metas if m]
        for (p, s, lab), meta, ((gp, gs, glab), gmeta) in zip(
                Runner.postprocess_dense(out, metas), live,
                results[n:n + len(live)]):
            assert gmeta["filename"] == meta["filename"]
            np.testing.assert_array_equal(glab, lab)
            np.testing.assert_allclose(gs, s, atol=1e-5)
            np.testing.assert_allclose(gp, p, atol=1e-3)
        n += len(live)
    assert n == len(results) == 4
    assert sum(len(s) for (_, s, _), _ in results) > 8
    assert tester.test_stats["detections"] > 8
