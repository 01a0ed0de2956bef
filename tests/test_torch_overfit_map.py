"""Detection quality in the port, in the JAX tests' own form
(``tests/test_map_pipeline.py:test_orcnn_overfits_to_real_detections``
and ``tests/test_int8_serving.py:test_overfit_map_holds_under_int8_serving``):
the tiny Oriented R-CNN of ``tests/test_runner.py:_tiny_cfg`` (Resnet18,
a 32-wide FPN and heads, SGD) trains through ``Runner.train`` for 200
epochs of 2 steps on 4 rendered 128^2 tiles with visible rotated
rectangles (``render_dataset``); ``Runner.val`` must give each of the two
classes an AP of at least 0.3; ``Runner.test`` over the tiles recast as
a 2 x 2 scene must merge detections onto the scene's ground truth; and
int8 serving (the FPN and RPN tower convs through ``ops/quant.py``, as
``RS_INT8=1`` does in the JAX package) must keep each class's AP within
0.05 of the float AP.

Nothing here imports jax: the config is a copy of ``_tiny_cfg`` (its
module imports jax), and ``render_dataset``'s module imports none. The
``slow`` forms train on the CPU, the ``cuda`` forms on the card.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from rs_detection_tpu_torch.config import get_cfg
from rs_detection_tpu_torch.config.constant import DOTA1_CLASSES
from rs_detection_tpu_torch.runner import Runner
from test_map_pipeline import render_dataset

OFFSETS = {0: (0, 0), 1: (128, 0), 2: (0, 128), 3: (128, 128)}


def tiny_cfg(ds_dir, work_dir, max_iter, shuffle=False):
    """``tests/test_runner.py:_tiny_cfg``, copied."""
    return dict(
        name="resume_eq",
        work_dir=work_dir,
        max_epoch=10,
        max_iter=max_iter,
        log_interval=100,
        checkpoint_interval=1,
        seed=3,
        model=dict(
            type="OrientedRCNN",
            backbone=dict(type="Resnet18", norm_eval=False),
            neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                      out_channels=32, num_outs=5),
            rpn=dict(type="OrientedRPNHead", in_channels=32,
                     feat_channels=32, nms_pre=64, nms_post=32,
                     pre_nms_cap=128,
                     sampler=dict(type="RandomSampler", num=32,
                                  pos_fraction=0.5)),
            bbox_head=dict(
                type="OrientedHead", num_classes=15, in_channels=32,
                fc_out_channels=64,
                sampler=dict(type="RandomSamplerRotated", num=16,
                             pos_fraction=0.25),
                bbox_roi_extractor=dict(
                    type="OrientedSingleRoIExtractor",
                    roi_layer=dict(type="ROIAlignRotated_v1",
                                   output_size=7, sampling_ratio=2),
                    out_channels=32, extend_factor=(1.4, 1.2),
                    featmap_strides=[4, 8, 16, 32]))),
        dataset=dict(
            train=dict(type="DOTADataset", dataset_dir=ds_dir,
                       batch_size=2, max_gt=8, shuffle=shuffle,
                       filter_empty_gt=False,
                       transforms=[
                           dict(type="RotatedResize", min_size=128,
                                max_size=128),
                           dict(type="Normalize",
                                mean=[123.675, 116.28, 103.53],
                                std=[58.395, 57.12, 57.375],
                                to_bgr=False)])),
        optimizer=dict(type="SGD", lr=0.01, momentum=0.9,
                       grad_clip=dict(max_norm=35)),
        scheduler=dict(type="StepLR", warmup="linear", warmup_iters=4,
                       warmup_ratio=0.25, milestones=[8]),
    )


def overfit_cfg(ds_dir, work_dir, tiles_dir):
    """The JAX overfit tests' changes to ``tiny_cfg``: 200 epochs at lr
    0.001 (warm-up 10 from 0.1, a milestone at 150), val on the training
    tiles, and a test set of the scene tiles in ``tiles_dir`` with the
    DOTA merge."""
    c = tiny_cfg(ds_dir, work_dir, max_iter=None)
    c["max_epoch"] = 200
    c["optimizer"]["lr"] = 0.001
    c["scheduler"] = dict(type="StepLR", warmup="linear", warmup_iters=10,
                          warmup_ratio=0.1, milestones=[150])
    c["dataset"]["val"] = dict(c["dataset"]["train"])
    c["dataset"]["test"] = dict(
        type="ImageDataset", images_dir=tiles_dir, dataset_type="DOTA",
        batch_size=2, transforms=list(c["dataset"]["train"]["transforms"]))
    c["merge_cfg"] = dict(dataset_type="DOTA")
    c["eval_interval"] = 9999
    c["checkpoint_interval"] = 9999
    c["log_interval"] = 10000
    return c


def scene_tiles(ds_dir, root):
    """The 4 training tiles as the 2 x 2 split grid of scene S0001 (DOTA
    split names ``<scene>__<scale>__<x>___<y>``)."""
    tiles = os.path.join(root, "tiles", "images")
    os.makedirs(tiles)
    for i, (ox, oy) in OFFSETS.items():
        shutil.copy(os.path.join(ds_dir, "images", f"tile_{i}.png"),
                    os.path.join(tiles, f"S0001__1.0__{ox}___{oy}.png"))
    return tiles


def class_aps(aps):
    keys = [k for k in aps if k.startswith(("eval/1_", "eval/2_"))]
    assert len(keys) == 2, aps
    return {k: float(aps[k]) for k in keys}


def trained_runner(root, device):
    """``Runner`` of ``overfit_cfg`` after its 200 epochs."""
    ds_dir = render_dataset(os.path.join(root, "ds"))
    cfg = get_cfg()
    cfg.clear()
    cfg.update(overfit_cfg(ds_dir, os.path.join(root, "w"),
                           scene_tiles(ds_dir, root)))
    runner = Runner(device=device)
    for _ in range(200):
        runner.train()
    return runner, ds_dir


def merged_dets(runner, scene="S0001"):
    """The merged after-NMS detections of ``scene`` for the two rendered
    classes: {class id: [(score, cx, cy), ...]}."""
    merged = os.path.join(runner.work_dir,
                          f"test/submit_{runner.epoch}/after_nms")
    dets = {}
    for cls_id in (1, 2):
        path = os.path.join(merged, DOTA1_CLASSES[cls_id - 1] + ".txt")
        if not os.path.exists(path):
            continue
        for line in open(path):
            f = line.split()
            if f[0] != scene:
                continue
            poly = np.asarray([float(v) for v in f[2:10]])
            dets.setdefault(cls_id, []).append(
                (float(f[1]), poly[0::2].mean(), poly[1::2].mean()))
    return dets


def match_count(dets, ds_dir, min_score=0.1):
    """(matched, total): the scene's ground truths (tile boxes plus tile
    offsets) with a detection of ``dets`` of their class within 24 px and
    a score of at least ``min_score``."""
    with open(os.path.join(ds_dir, "labels.pkl"), "rb") as fh:
        infos = pickle.load(fh)
    matched = total = 0
    for i, info in enumerate(infos):
        ox, oy = OFFSETS[i]
        for box, lab in zip(info["ann"]["bboxes"], info["ann"]["labels"]):
            total += 1
            gx, gy = box[0] + ox, box[1] + oy
            matched += any(abs(cx - gx) < 24 and abs(cy - gy) < 24
                           and s >= min_score
                           for s, cx, cy in dets.get(int(lab), []))
    return matched, total


def merged_matches(runner, ds_dir):
    """``match_count`` of the merged detections of scene S0001."""
    return match_count(merged_dets(runner), ds_dir)


def check_trained(runner, ds_dir, int8=False):
    """Hold a trained runner's ``Runner.val`` APs (and with ``int8`` the
    int8 serving APs) and its merged scene detections to the JAX tests'
    gates; returns {"aps", "aps_int8" (with ``int8``), "matched":
    (matched, total)}."""
    out = dict(aps=class_aps(runner.val()))
    assert all(v >= 0.3 for v in out["aps"].values()), out
    if int8:
        runner.model.neck.int8 = runner.model.rpn.int8 = True
        out["aps_int8"] = class_aps(runner.val())
        runner.model.neck.int8 = runner.model.rpn.int8 = False
        for k, v in out["aps"].items():
            assert out["aps_int8"][k] >= v - 0.05, out
    runner.test(flip_test=False)
    out["matched"] = merged_matches(runner, ds_dir)
    matched, total = out["matched"]
    # per-class tile AP >= 0.3 implies a healthy share of the scene's
    # ground truths once the merge puts the tile offsets back
    assert matched >= total * 0.4, out
    return out


def check_overfit(root, device, int8=False):
    """Train (``trained_runner``), then ``check_trained``."""
    runner, ds_dir = trained_runner(root, device)
    return check_trained(runner, ds_dir, int8)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


@pytest.mark.slow
def test_orcnn_overfits_to_real_detections(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # submit_zips/ is cwd-relative
    print("overfit on the CPU:", check_overfit(str(tmp_path), "cpu"))


@pytest.mark.slow
def test_overfit_map_holds_under_int8_serving(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    print("overfit on the CPU, int8 serving:",
          check_overfit(str(tmp_path), "cpu", int8=True))


@pytest.mark.cuda
def test_orcnn_overfits_to_real_detections_cuda(card, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    print("overfit on the card:", check_overfit(str(tmp_path), card))


@pytest.mark.cuda
def test_overfit_map_holds_under_int8_serving_cuda(card, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    print("overfit on the card, int8 serving:",
          check_overfit(str(tmp_path), card, int8=True))


def test_resnet_sgd_path_imports_no_jax():
    """The ResNet + SGD path (a config-built tiny ResNet Oriented R-CNN
    with an EQLv2 head: predict, one SGD step, a save of its state) in a
    fresh interpreter pulls in no jax, flax, optax or JAX package."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, torch\n"
        "sys.path.insert(0, 'tests')\n"
        "from test_torch_overfit_map import tiny_cfg\n"
        "from rs_detection_tpu_torch.flagship import make_targets\n"
        "from rs_detection_tpu_torch.models.networks import rcnn\n"
        "from rs_detection_tpu_torch.optims.lr_scheduler import StepLR\n"
        "from rs_detection_tpu_torch.optims.optimizer import SGD\n"
        "from rs_detection_tpu_torch.parallel.train_step import train_step\n"
        "from rs_detection_tpu_torch.utils.checkpoint import "
        "optimizer_arrays\n"
        "from rs_detection_tpu_torch.utils.registry import MODELS, "
        "build_from_cfg\n"
        "cfg = tiny_cfg('', '', None)['model']\n"
        "cfg['bbox_head']['type'] = 'OrientedEQLv2Head'\n"
        "m = build_from_cfg(cfg, MODELS)\n"
        "m.eval().predict(torch.zeros(1, 64, 64, 3))\n"
        "g = torch.Generator().manual_seed(0)\n"
        "opt = SGD(m.parameters(), grad_clip=dict(max_norm=35))\n"
        "train_step(m, opt, StepLR([8]), torch.zeros(2, 64, 64, 3),\n"
        "           make_targets(2, 64, 4, g), g, epoch=0)\n"
        "assert optimizer_arrays(opt, m)['iterations'] == 1\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'rs_detection_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
