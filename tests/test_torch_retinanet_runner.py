"""The port's runner on a tiny RetinaNet config in the legacy schema of
``projects/retinanet`` (``rpn_net``, ``GradMutilpySGD`` and the
``YangXuePrameterGroupsGenerator`` groups) against the JAX runner, CPU,
f32: ``Runner.run`` (the train task of ``run_net``) for 3 steps on the 4
rendered tiles of ``tests/test_map_pipeline.py:render_dataset`` from the
same weights (the JAX init, perturbed), with the clip scaling every step:
rates, losses and every parameter. This holds the optimizer's link order
(the conv biases' doubled gradients and their decay correction inside
the global-norm clip, the frozen stem). Then ``Runner.test`` (the test
task) on two of the tiles against the JAX network's ``predict``; the JAX
runner's own test task cannot serve a single-stage network (ROADMAP.md,
Queue 3).

The JAX ``_prefix_mask`` matches the reference's ``backbone.C1`` against
the flax tree, whose top names are ``_backbone`` / ``_neck`` /
``_bbox_head``: it matches nothing and raises, so the JAX runner cannot
train the zoo's recipe as written (ROADMAP.md, Queue 3). The JAX side
here is given ``_backbone.C1``, the same stem."""

import copy
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import rs_detection_tpu.runner.runner as jrunner
from rs_detection_tpu.config import get_cfg as jget_cfg
from rs_detection_tpu.models import param_generators as jpg
from rs_detection_tpu.parallel.train_step import (create_train_state,
                                                  make_train_step)
from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.optims import optimizer as optim_mod
from rs_detection_tpu_torch.runner import Runner
from rs_detection_tpu_torch.utils.jax_weights import jax_to_state_dict
from test_map_pipeline import render_dataset
from test_torch_port_slice import perturb
from test_torch_retinanet_networks import legacy_head
from torch_one_thread import _one_thread  # noqa: F401

NORM = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_bgr=False)
RESIZE = dict(type="RotatedResize", min_size=128, max_size=128)
# the test task at 32^2: 23 positions x 18 anchors, so that the JAX NMS
# takes 828 candidates an image, not 2,000 (~18 s an image on the CPU)
TEST_RESIZE = dict(type="RotatedResize", min_size=32, max_size=32)
STEPS = 3
# per step: warmup 0.25 -> 1 over 4 iterations
WANT_LRS = [0.01 * (0.25 + 0.75 * i / 4) for i in range(STEPS)]
MAX_NORM = 0.5
STEM = ("backbone.Conv_0.weight", "backbone.Norm_0.weight",
        "backbone.Norm_0.bias")


def retina_cfg(ds, work_dir, stem_prefix, test_dir=None, **extra):
    """A tiny RetinaNet as ``retinanet_r50v1d_fpn_dota.py`` writes it:
    Resnet18 with running statistics, a 32-wide FPN from C3 with
    ``on_output`` extra convs after a ReLU, the legacy ``rpn_net`` at 32
    channels (18 anchors a position, 2 classes); ``GradMutilpySGD`` with
    the recipe's groups (``freeze_prefix`` = ``stem_prefix``); the
    rendered tiles to train on (batch 2, 8 slots) and to test (those of
    ``test_dir`` when given)."""
    cfg = dict(
        name="retina_runner", work_dir=work_dir, seed=3, max_epoch=10,
        max_iter=STEPS, log_interval=1, checkpoint_interval=1,
        model=dict(
            type="RetinaNet",
            backbone=dict(type="Resnet18", norm_eval=True),
            neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                      out_channels=32, start_level=1, num_outs=5,
                      add_extra_convs="on_output",
                      relu_before_extra_convs=True),
            rpn_net=legacy_head()),
        dataset=dict(
            train=dict(type="DOTADataset", dataset_dir=ds, batch_size=2,
                       max_gt=8, shuffle=False, filter_empty_gt=False,
                       transforms=[RESIZE, NORM]),
            test=dict(type="ImageDataset",
                      images_dir=test_dir or os.path.join(ds, "images"),
                      dataset_type="DOTA", batch_size=2,
                      transforms=[TEST_RESIZE, NORM])),
        optimizer=dict(type="GradMutilpySGD", lr=0.01, momentum=0.9,
                       weight_decay=1e-4, grad_clip=dict(max_norm=MAX_NORM)),
        parameter_groups_generator=dict(
            type="YangXuePrameterGroupsGenerator",
            conv_bias_grad_muyilpy=2.0, conv_bias_weight_decay=0.0,
            freeze_prefix=[stem_prefix]),
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
    """The JAX runner's 3 steps and the port's from the same weights, the
    port's global gradient norms; a second weights file with the
    classifier spread (so that the random head detects) for the test
    task."""
    root = tmp_path_factory.mktemp("retina_runner")
    ds = render_dataset(str(root / "ds"))
    mp = pytest.MonkeyPatch()
    records = []
    try:
        _use(jget_cfg, retina_cfg(ds, str(root / "jax"), "_backbone.C1"))
        jr = jrunner.Runner()
        images, targets, _ = next(iter(jr.train_dataset.batches()))
        weights = perturb(jax.jit(lambda i: jr.model.init(
            {"params": jax.random.PRNGKey(3)}, i))(
            jnp.asarray(images[:1])), seed=7)
        with open(root / "weights.pkl", "wb") as f:
            pickle.dump(weights, f)
        lifted = copy.deepcopy(weights)
        cls = lifted["params"]["_bbox_head"]["retina_cls"]
        cls["kernel"] = cls["kernel"] * 60.0
        cls["bias"] = np.random.RandomState(8).randn(
            *cls["bias"].shape).astype(np.float32)
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
    norms = []
    clip = optim_mod.clip_by_global_norm

    def recording(grads, max_norm):
        norms.append(float(clip(grads, max_norm)))
        return norms[-1]

    _use(get_cfg, retina_cfg(ds, str(root / "port"), "backbone.C1",
                             pretrained_weights=str(root / "weights.pkl")))
    mp.setattr(optim_mod, "clip_by_global_norm", recording)
    try:
        port = Runner(device="cpu")
        port.run()
    finally:
        mp.undo()
    return dict(ds=ds, root=root, jax_records=records, jax_params=ref,
                start=jax_to_state_dict(weights), port=port, jmodel=jmodel,
                lifted=lifted, norms=norms)


def test_the_jax_recipe_prefix_matches_nothing_in_the_flax_tree():
    """The zoo's ``freeze_prefix=["backbone.C1"]`` raises in the JAX
    package at ``tx.init``: its params tree names the backbone
    ``_backbone``. The port's names are ``backbone.*``
    (``tests/test_torch_retinanet_configs.py``)."""
    params = {"_backbone": {"Conv_0": {"kernel": jnp.zeros((3, 3, 3, 4))}},
              "_bbox_head": {"cls_0": {"bias": jnp.zeros(4)}}}
    tx = jpg.YangXuePrameterGroupsGenerator(freeze_prefix=["backbone.C1"])(
        optax.sgd(0.1), base_weight_decay=1e-4)
    with pytest.raises(ValueError, match="matched NO parameters"):
        tx.init(params)


def test_train_task_rates_losses_and_clip_match_jax(trained):
    """Each step's rate exactly, its two losses to 1e-5 relative, the
    clip scaling every step (global norm above its 0.5)."""
    got, ref = trained["port"].history, trained["jax_records"]
    assert len(got) == len(ref) == STEPS
    assert type(trained["port"].optimizer).__name__ == "GradMutilpySGD"
    np.testing.assert_allclose([r["lr"] for r in got], WANT_LRS, rtol=1e-12)
    for g, r in zip(got, ref):
        for k, v in r.items():
            if "loss" in k:
                assert abs(g[k] - v) <= 1e-5 * abs(v), (k, g[k], v)
        assert r["loss_bbox"] > 0
    assert len(trained["norms"]) == STEPS
    assert min(trained["norms"]) > MAX_NORM


def test_train_task_parameters_match_jax(trained):
    """Every parameter and running statistic within 1e-5 of the JAX
    runner's after 3 steps; the frozen stem where it started on both
    sides, the conv biases and the head moved."""
    got = {k: v.detach().numpy()
           for k, v in trained["port"].model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    ref, start = trained["jax_params"], trained["start"]
    assert set(got) == set(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=0, atol=1e-5, err_msg=k)
    for k in STEM:
        assert np.array_equal(got[k], start[k]) and np.array_equal(
            ref[k], start[k]), k
    for k in ("bbox_head.retina_cls.bias", "bbox_head.cls_0.bias",
              "neck.fpn_convs_0.bias"):
        if k in ref:
            assert np.abs(ref[k] - start[k]).max() > 0, k


def test_test_task_matches_jax_predict(trained, tmp_path):
    """``Runner.test`` from the spread weights on two of the tiles (one
    batch, at 32^2, boxes divided by the 0.25 resize) against the JAX
    network's ``predict`` of the same batch, read
    by the port's ``postprocess_dense``: per tile the same detections,
    labels and scores (to 1e-5), polygons to 1e-3 px."""
    root = trained["root"]
    tiles = tmp_path / "tiles"
    os.makedirs(tiles)
    for name in ("tile_0.png", "tile_1.png"):
        shutil.copy(os.path.join(trained["ds"], "images", name), tiles)
    _use(get_cfg, retina_cfg(trained["ds"], str(tmp_path / "test"),
                             "backbone.C1", test_dir=str(tiles),
                             pretrained_weights=str(root / "lifted.pkl")))
    tester = Runner(device="cpu")
    tester.test()
    with open(tmp_path / "test" / "test" / "test_0.pkl", "rb") as f:
        results = pickle.load(f)
    jm = trained["jmodel"]
    lifted = jax.tree_util.tree_map(jnp.asarray, trained["lifted"])
    predict = jax.jit(lambda v, i, sf: jm.apply(
        v, i, {"scale_factor": sf}, method=jm.predict))
    n = 0
    for images, targets, metas in tester.test_dataset.batches():
        out = jax.tree_util.tree_map(np.asarray, predict(
            lifted, jnp.asarray(images),
            jnp.asarray(targets["scale_factor"], jnp.float32)))
        live = [m for m in metas if m]
        for (p, s, lab), meta, ((gp, gs, glab), gmeta) in zip(
                Runner.postprocess_dense(out, metas), live,
                results[n:n + len(live)]):
            assert gmeta["filename"] == meta["filename"]
            np.testing.assert_array_equal(glab, lab)
            np.testing.assert_allclose(gs, s, atol=1e-5)
            np.testing.assert_allclose(gp, p, atol=1e-3)
        n += len(live)
    assert n == len(results) == 2
    assert min(len(s) for (_, s, _), _ in results) > 2
