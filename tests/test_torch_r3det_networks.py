"""R3Det in the port against the JAX package, CPU, f32: the tiny network
of ``tests/test_torch_r3det_cuda.py:tiny_model`` (the zoo config's
schema: a ``RetinaHead``, two ``refine_heads`` and two ``frm_cfgs`` of
which both packages build the first) built by each framework's registry
from one config, seeded JAX variables (perturbed) carried across by
``load_jax_variables`` (``_frm`` -> ``frm``, ``_refine_head`` ->
``refine_head``): the refined boxes, the four training losses and
``predict`` (the refine classifier spread so that the random head
detects) on seeded tiles, and a saved JAX tree loading into every parameter. Then the
port's runner from the same weights, as ``tests/test_torch_fcos_
networks.py`` drives it: the train task's first step against JAX's
``loss`` of the same batch, the test task against JAX's ``predict``. One
JAX compile serves every comparison."""

import pickle

import jax
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.flagship import normalize
from rs_detection_tpu_torch.models.networks.r3det import (
    FeatureRefineModule, R3DetRefineHead)
from rs_detection_tpu_torch.models.roi_heads.retina_head import RetinaHead
from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (load_jax_checkpoint,
                                                      load_jax_variables)
from test_torch_fcos_networks import (IMG, _one_thread,  # noqa: F401
                                      assert_first_step_matches,
                                      assert_same_detections,
                                      assert_test_task_matches, compile_run,
                                      jax_targets, random_variables,
                                      runner_tasks, spread_classifier)
from test_torch_r3det_cuda import tiny_inputs, tiny_model

LOSSES = ("loss_cls", "loss_bbox", "loss_refine_cls", "loss_refine_bbox")


def assignment_margin(anchors, targets, thresholds):
    """The smallest gap, over the images, between any anchor's best IoU
    and the assigner's thresholds (positive, negative), and, for a box
    whose best anchor IoU is below the positive threshold (the
    low-quality rescue picks by rank there), between its best and
    second-best anchor IoU; ``anchors`` [A, 5] shared or [B, A, 5] an
    image. The packages' rotated IoUs agree to 1e-5, not bit for bit."""
    worst = 1.0
    for b in range(targets["rboxes"].shape[0]):
        live = torch.from_numpy(targets["gt_mask"][b])
        a = anchors if anchors.dim() == 2 else anchors[b]
        iou = box_iou_rotated(a, torch.from_numpy(targets["rboxes"][b])[live])
        top2 = iou.topk(2, dim=0).values
        rescued = top2[0] < thresholds[0]
        gaps = (top2[0] - top2[1])[rescued]
        best = iou.amax(1)
        worst = min([worst] + gaps.tolist()
                    + [(best - t).abs().min().item() for t in thresholds])
    return worst


@pytest.fixture(scope="module")
def net(tmp_path_factory):
    """The JAX network with seeded variables and the port's with them;
    JAX's losses and, with the refine classifier spread, ``predict`` on seeded tiles; the port's runner tasks from the
    spread weights beside JAX's loss and ``predict`` of their batches
    (tiles rendered with seed 11, whose first batch has no exact tie of a
    box's best anchor IoU, ``assignment_margin``)."""
    tiles, t = tiny_inputs(img=IMG, axis_aligned=False)
    images = normalize(tiles).numpy()
    targets = jax_targets(t)
    cfg = tiny_model()
    jm = jreg.build_from_cfg(cfg, jreg.MODELS)
    v = random_variables(jm, images.shape, seed=7,
                         heads=("_bbox_head", "_frm", "_refine_head"))
    spread = spread_classifier(v, "_refine_head", "out_cls")
    run = compile_run(jm)
    loss, pred = run(v, spread, images, targets, np.ones(2, np.float32))
    tasks = runner_tasks(tmp_path_factory.mktemp("r3det_runner"),
                         "r3det_runner", tiny_model(), spread, run, seed=11)
    return dict(cfg=cfg, images=images, targets=targets, v=v, loss=loss,
                pred=pred, tasks=tasks,
                port=load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS),
                                        v),
                spread=load_jax_variables(
                    reg.build_from_cfg(cfg, reg.MODELS), spread))


def test_builds_one_refine_stage_from_the_first_entries(net):
    """A ``RetinaHead`` of 9 anchors a position, one ``R3DetRefineHead``
    (2 classes, two convs a branch) and one ``FeatureRefineModule`` on
    strides 8-128, as the JAX network builds from the lists' first
    entries."""
    port = net["port"]
    assert isinstance(port.bbox_head, RetinaHead)
    assert port.bbox_head.num_anchors == 9
    assert isinstance(port.refine_head, R3DetRefineHead)
    assert port.refine_head.cls_out_channels == 2
    assert port.refine_head.stacked_convs == 2
    assert isinstance(port.frm, FeatureRefineModule)
    assert port.frm.featmap_strides == (8, 16, 32, 64, 128)
    assert set(net["v"]["params"]) == {"_backbone", "_neck", "_bbox_head",
                                       "_frm", "_refine_head"}


def test_loss_matches_jax(net):
    """The first stage's focal and smooth-L1 losses and the refine
    stage's within 1e-5 relative, all above 0, on boxes with no near-tie
    in either stage's assignment (``assignment_margin`` above 1e-4: the
    anchors at 0.5 / 0.4, the refined boxes at the refine head's 0.6 /
    0.5)."""
    port = net["port"].train()
    images = torch.from_numpy(net["images"])
    with torch.no_grad():
        outs = port.bbox_head(port.extract_feats(images), train=True)
        refined = port.refined_anchors(outs[1])
    head = port.bbox_head
    anchors = torch.cat([head.anchors(i, o.shape[1:3], "cpu")
                         for i, o in enumerate(outs[0])])
    assert assignment_margin(anchors, net["targets"], (0.5, 0.4)) > 1e-4
    flat = torch.cat([r.reshape(2, -1, 5) for r in refined], 1)
    assert assignment_margin(flat, net["targets"], (0.6, 0.5)) > 1e-4
    got = port.loss(images, {k: torch.from_numpy(x)
                             for k, x in net["targets"].items()})
    assert set(got) == set(net["loss"]) == set(LOSSES)
    for k, r in net["loss"].items():
        g = float(got[k].detach())
        assert r > 0 and abs(g - r) <= 1e-5 * r, (k, g, r)


def test_predict_matches_jax(net):
    """``predict`` with the refine classifier spread: the refine deltas
    decoded against the refined boxes, the same valid slots and the same
    detections (labels, scores to 5e-5, polygons to 1e-3 px), with
    detections in both images."""
    ref = net["pred"]
    got = net["spread"].eval().predict(torch.from_numpy(net["images"]))
    assert ref["valid"].sum(1).min() > 2
    assert_same_detections(got, ref)


def test_saved_jax_tree_loads(net, tmp_path):
    """A JAX R3Det tree pickled as numpy arrays loads through
    ``load_jax_checkpoint`` / ``load_jax_variables`` with no name left
    over on either side: the FRM's 1x5, 5x1 and 1x1 convs and the refine
    head's convs equal to the tree. A tree with a top name the port does
    not know raises."""
    path = tmp_path / "r3det.pkl"
    with open(path, "wb") as f:
        pickle.dump(net["v"], f)
    port = reg.build_from_cfg(net["cfg"], reg.MODELS)
    load_jax_variables(port, load_jax_checkpoint(str(path)))
    sd = port.state_dict()
    params = net["v"]["params"]
    for top, name in (("_frm", "conv_1_5_0"), ("_frm", "conv_5_1_4"),
                      ("_frm", "conv_1_1_2"), ("_refine_head", "cls_1"),
                      ("_refine_head", "out_reg")):
        mod = "frm" if top == "_frm" else "refine_head"
        np.testing.assert_array_equal(
            sd[f"{mod}.{name}.weight"].numpy(),
            params[top][name]["kernel"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd[f"{mod}.{name}.bias"].numpy(),
                                      params[top][name]["bias"])
    assert sd["frm.conv_1_5_0.weight"].shape[2:] == (1, 5)
    renamed = dict(net["v"], params=dict(params, _refine=params[
        "_refine_head"]))
    del renamed["params"]["_refine_head"]
    with pytest.raises(ValueError, match="do not match"):
        load_jax_variables(reg.build_from_cfg(net["cfg"], reg.MODELS),
                           renamed)


def test_train_task_first_step_losses_match_jax(net):
    """``Runner.run``'s first step: its four losses within 1e-5 relative
    of JAX's ``loss`` of the same batch from the same weights, with no
    near-tie in either stage's assignment (``assignment_margin`` above
    1e-4 on the port's refined boxes of those weights;
    ``assert_first_step_matches``)."""
    tasks = net["tasks"]
    images, targets, _ = tasks["batch"]
    t = {k: np.asarray(x) for k, x in targets.items()}
    model = net["spread"].eval()
    with torch.no_grad():
        outs = model.bbox_head(model.extract_feats(torch.as_tensor(images)))
        refined = model.refined_anchors(outs[1])
    anchors = torch.cat([model.bbox_head.anchors(i, r.shape[1:3], "cpu")
                         for i, r in enumerate(refined)])
    assert assignment_margin(anchors, t, (0.5, 0.4)) > 1e-4
    flat = torch.cat([r.reshape(2, -1, 5) for r in refined], 1)
    assert assignment_margin(flat, t, (0.6, 0.5)) > 1e-4
    assert_first_step_matches(tasks)


def test_test_task_matches_jax_predict(net):
    """``Runner.test`` on two tiles (one batch) against JAX ``predict``
    of the same batch: the refine deltas decoded against the refined
    boxes (``assert_test_task_matches``)."""
    assert_test_task_matches(net["tasks"])
