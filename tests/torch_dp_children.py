"""Processes of the data-parallel tests: ``run_world`` starts W copies of
this file, each joining a gloo group on the CPU (through torchrun's
environment variables, as ``tools/run_net.py`` reads them) and running
one of the tasks below on its rows of a global batch; each writes what
it computed to ``rank{r}.pkl``. A task called in the test's own process
(no group) is the one-process reference on the whole batch.

The children import the port and torch only (no jax), on one intra-op
thread each."""

from __future__ import annotations

import json
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(task: str, world: int, args: dict, tmp, timeout=240):
    """Run ``task(**args)`` in ``world`` processes over gloo; returns each
    rank's result. A child that fails, or a run that outlasts
    ``timeout`` seconds, fails the caller (every child is killed)."""
    tmp = str(tmp)
    port = free_port()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, HERE]))
    procs = []
    for r in range(world):
        env_r = dict(env, RANK=str(r), LOCAL_RANK=str(r))
        log = open(os.path.join(tmp, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, tmp,
             json.dumps(args)], env=env_r, cwd=tmp, stdout=log,
            stderr=subprocess.STDOUT), log))
    deadline = time.time() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{task}: the {world} ranks outlasted "
                             f"{timeout} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    outs = []
    for r, (p, _) in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                raise AssertionError(f"{task}: rank {r} exited "
                                     f"{p.returncode}:\n{f.read()[-4000:]}")
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))
    return outs


# ---------------------------------------------------------------------------
# tasks (each runs the same in a child and in the test's process)

def tiny_batch(n: int, seed: int = 21, img: int = 64):
    """``n`` seeded 64^2 images with four ground truths each (near
    anchors of several shapes, so both stages get positives; the last
    slot of every other image padded), as numpy."""
    rng = np.random.RandomState(seed)
    images = rng.randn(n, img, img, 3).astype(np.float32)
    base = np.array([[26, 26, 32, 32, 0.05], [42, 34, 44, 22, -0.08],
                     [20, 46, 24, 12, 0.7], [48, 14, 10, 20, -1.2]],
                    np.float32)
    rboxes = np.stack([base + rng.uniform(-2, 2, base.shape).astype(
        np.float32) * np.float32([1, 1, 1, 1, 0.05]) for _ in range(n)])
    gt_mask = np.ones((n, 4), bool)
    gt_mask[1::2, 3] = False
    rboxes[~gt_mask] = 0
    labels = np.where(gt_mask, rng.randint(1, 11, (n, 4)), 0).astype(
        np.int32)
    img_hw = np.full((n, 2), float(img), np.float32)
    return images, dict(rboxes=rboxes, gt_mask=gt_mask, labels=labels,
                        img_hw=img_hw)


def _tiny_orcnn(weights, drop_path, take_all, device="cpu"):
    import torch

    from rs_detection_tpu_torch.flagship import build_flagship
    from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
    from rs_detection_tpu_torch.models.utils.modules import DropPath
    from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables

    model = build_flagship(tiny=True, device=device, train=True,
                           generator=torch.Generator().manual_seed(4))
    if weights is not None:
        with open(weights, "rb") as f:
            load_jax_variables(model, pickle.load(f))
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = drop_path
    if take_all:
        model.rpn.sampler = RandomSampler(num=4096, pos_fraction=1.0)
        model.bbox_head.sampler = RandomSampler(
            num=64 + 4, pos_fraction=1.0, add_gt_as_proposals=True)
    else:
        # fewer slots than candidates, so that the draw picks a subset
        # (the flagship's 256 and 512 take every candidate of a 64^2 tile)
        model.rpn.sampler = RandomSampler(num=48, pos_fraction=0.5)
        model.bbox_head.sampler = RandomSampler(
            num=24, pos_fraction=0.25, add_gt_as_proposals=True)
    return model


def _state(model, opt):
    import torch
    return dict(
        grads={k: (torch.zeros_like(p) if p.grad is None else p.grad)
               .cpu().numpy().copy() for k, p in model.named_parameters()},
        params={k: p.detach().cpu().numpy().copy()
                for k, p in model.named_parameters()},
        stats={k: v.cpu().numpy().copy()
               for k, v in model.state_dict().items()
               if k.endswith(("running_mean", "running_var"))},
        lr=opt.param_groups[0]["lr"])


def orcnn_step(n=4, drop_path=0.0, take_all=False, weights=None,
               seed=21, device="cpu"):
    """One AdamW step (StepLR warmup, clip 35) of the tiny Oriented R-CNN
    on the rank's rows of ``tiny_batch(n)`` on ``device``: losses,
    clipped gradients, parameters and BN statistics after it."""
    import torch

    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import AdamW
    from rs_detection_tpu_torch.parallel import dist
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model = _tiny_orcnn(weights, drop_path, take_all, device)
    images, targets = tiny_batch(n, seed)
    opt = AdamW(model.parameters(), lr=1e-4, weight_decay=0.05,
                grad_clip=dict(max_norm=35))
    sched = StepLR(milestones=[7, 10], warmup="linear", warmup_iters=500,
                   warmup_ratio=1.0 / 3)
    torch.manual_seed(5)
    losses = train_step(
        model, opt, sched, dist.rows(torch.from_numpy(images).to(device)),
        {k: dist.rows(torch.from_numpy(v).to(device))
         for k, v in targets.items()},
        torch.Generator(device=device).manual_seed(6), epoch=0)
    return dict(losses={k: float(v) for k, v in losses.items()},
                **_state(model, opt))


def orcnn_eval(n=3, weights=None, seed=22, device="cpu"):
    """``make_eval_step`` of the tiny Oriented R-CNN (eval mode) on
    ``tiny_batch(n)``'s images on ``device``: the gathered dense
    outputs."""
    import torch

    from rs_detection_tpu_torch.parallel.train_step import make_eval_step

    model = _tiny_orcnn(weights, 0.0, False, device).eval()
    images, _ = tiny_batch(n, seed)
    out = make_eval_step(model)(torch.from_numpy(images).to(device),
                                torch.ones(n, device=device))
    return {k: v.cpu().numpy() for k, v in out.items()}


def _family(family, n, seed):
    """(model in train mode, images [n], targets) of a family's tiny
    network and inputs from its card tests (``tests/test_torch_*_cuda``):
    S2ANet (the zoo's frozen first ResNet-18 stage, 128^2), FCOS (64^2,
    axis-aligned boxes), SSD (96^2) and YOLOv5 (128^2, no EMA)."""
    import torch

    from rs_detection_tpu_torch.flagship import (init_weights, make_targets,
                                                 normalize)
    from rs_detection_tpu_torch.utils import registry as reg

    g = torch.Generator().manual_seed(seed)
    if family in ("s2anet", "fcos"):
        import test_torch_fcos_cuda
        import test_torch_s2anet_cuda
        cfg, img = ((test_torch_s2anet_cuda.tiny_model(), 128)
                    if family == "s2anet"
                    else (test_torch_fcos_cuda.tiny_model(), 64))
        tiles = torch.randint(0, 256, (n, img, img, 3), generator=g,
                              dtype=torch.uint8)
        targets = make_targets(n, img, 6, g)
        targets["labels"] = targets["labels"].clamp(max=3)
        if family == "fcos":
            targets["rboxes"][..., 4] = 0.0
    else:
        mod = __import__(f"test_torch_{family}_cuda")
        cfg = (mod.tiny_model(ema=False) if family == "yolo"
               else mod.tiny_model())
        tiles, targets = mod.tiny_inputs(seed=seed, batch=n)
    model = reg.build_from_cfg(cfg, reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    return model.train(), normalize(tiles), targets


def family_step(family="s2anet", n=4, seed=23, device="cpu"):
    """One SGD step of a family's tiny network on the rank's rows of ``n``
    seeded tiles: the losses divide by counts over the batch (S2ANet,
    FCOS, SSD's mined negatives, YOLO's positives and batch)."""
    import torch

    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel import dist
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model, images, targets = _family(family, n, seed)
    model.to(device)
    opt = SGD(model.named_parameters(), lr=0.01)
    losses = train_step(
        model, opt, lambda lr, s, e: lr, dist.rows(images.to(device)),
        {k: dist.rows(v.to(device)) for k, v in targets.items()}, None,
        epoch=0)
    return dict(losses={k: float(v) for k, v in losses.items()},
                **_state(model, opt))


def make_run(root, work, img=64, n=4):
    """``n`` seeded tiles with a ``labels.pkl`` under ``root/ds`` and a
    config file for ``run_net``: ``img``^2 tiles but the second,
    ``img`` x 1.5 ``img`` (so one rank's rows collate smaller than the
    global batch), the tiny Oriented R-CNN with its real samplers and
    DropPath at 0.2, a global batch of ``n`` (one step an epoch) read by
    2 loader threads with flips and rotations, AdamW, 2 epochs, val on
    3-image batches (the last one short); returns the config's path."""
    from PIL import Image

    from rs_detection_tpu_torch.flagship import flagship_cfg

    ds = os.path.join(root, "ds")
    os.makedirs(os.path.join(ds, "images"), exist_ok=True)
    rng = np.random.RandomState(0)
    infos = []
    for i in range(n):
        name = f"t{i}.png"
        w = img * 3 // 2 if i == 1 else img
        Image.fromarray(rng.randint(0, 256, (img, w, 3)).astype(
            np.uint8)).save(os.path.join(ds, "images", name))
        boxes = np.array([[26, 26, 32, 32, 0.05], [42, 34, 44, 22, -0.08],
                          [20, 46, 24, 12, 0.7]], np.float32)
        infos.append(dict(filename=name, width=w, height=img, ann=dict(
            bboxes=boxes, labels=np.array([1, 2, 5]),
            bboxes_ignore=np.zeros((0, 5), np.float32))))
    with open(os.path.join(ds, "labels.pkl"), "wb") as f:
        pickle.dump(infos, f)
    model = flagship_cfg(tiny=True)
    model["backbone"]["drop_path_rate"] = 0.2
    norm = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_bgr=False)
    resize = dict(type="RotatedResize", min_size=img, max_size=img * 3 // 2)
    pad = dict(type="Pad", size_divisor=32)
    cfg = dict(
        name="dp", work_dir=str(work), seed=3, model=model, max_epoch=2,
        log_interval=1, checkpoint_interval=1,
        dataset=dict(
            train=dict(type="FAIR1M_1_5_Dataset", dataset_dir=ds,
                       batch_size=n, shuffle=True, max_gt=8, num_workers=2,
                       transforms=[
                           resize, dict(type="RotatedRandomFlip", prob=0.5),
                           dict(type="RandomRotateAug",
                                random_rotate_on=True), pad, norm]),
            val=dict(type="FAIR1M_1_5_Dataset", dataset_dir=ds, batch_size=3,
                     max_gt=8, transforms=[resize, pad, norm])),
        optimizer=dict(type="AdamW", lr=1e-4, weight_decay=0.05,
                       grad_clip=dict(max_norm=35)))
    path = os.path.join(root, f"dp_{os.path.basename(str(work))}.py")
    with open(path, "w") as f:
        for k, v in cfg.items():
            f.write(f"{k} = {v!r}\n")
    return path


def run_net(argv):
    """``tools/run_net.main(argv)`` as torchrun would start it: the
    runner's logged records, APs, parameters' digest, and the parameters
    and the last step's (averaged, clipped) gradients."""
    import hashlib

    import torch

    from rs_detection_tpu_torch.tools import run_net as tool

    torch.use_deterministic_algorithms(True)
    runner = tool.main(argv)
    h = hashlib.sha256()
    for k, p in sorted(runner.model.state_dict().items()):
        h.update(k.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return dict(history=runner.history, aps=runner.val_aps,
                digest=h.hexdigest(),
                params={k: p.detach().numpy().copy()
                        for k, p in runner.model.named_parameters()},
                grads={k: (np.zeros(p.shape, np.float32) if p.grad is None
                           else p.grad.numpy().copy())
                       for k, p in runner.model.named_parameters()})


def several(calls):
    """Several tasks in one process, in order: their results."""
    return [TASKS[name](**kw) for name, kw in calls]


TASKS = dict(orcnn_step=orcnn_step, orcnn_eval=orcnn_eval,
             family_step=family_step, run_net=run_net, several=several)


def _child(task, tmp, args):
    """Join the group (gloo, on the CPU or, with ``device`` in the args or
    in its tasks' args, on that card: NCCL refuses two ranks on one),
    run the task, write its result."""
    import torch

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from rs_detection_tpu_torch.parallel import dist

    grouped = task != "run_net"
    if grouped:
        calls = args.get("calls", [(task, args)])
        device = calls[0][1].get("device", "cpu")
        dist.init_process_group(backend="gloo", device=device)
    try:
        out = TASKS[task](**args)
    finally:
        if grouped:
            dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{os.environ['RANK']}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    _child(sys.argv[1], sys.argv[2], json.loads(sys.argv[3]))
