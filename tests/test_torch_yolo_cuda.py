"""YOLOv5 on a CUDA GPU against the CPU (``python -m pytest -m cuda
--noconftest tests/test_torch_yolo_cuda.py`` on the card; every test here
skips without one): the narrow network's losses, gradients, ``get_bboxes``
and three SGD steps with the EMA. Also the torch-only pieces the CPU
tests and ``chip_smoke.py`` share: the narrow network as a config
section, its inputs, its run, and the NMS margin that keeps f32 rounding
from deciding a suppression."""

import numpy as np
import pytest
import torch

from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda

# the card against the CPU, f32: the losses (relative), every gradient
# (of its largest entry), the detections' boxes (px) and scores, the
# parameters and the EMA after three steps (of their largest entry)
LOSS_RTOL, GRAD_RTOL, POLY_ATOL, SCORE_ATOL, STEP_RTOL = \
    1e-4, 1e-3, 1e-2, 1e-5, 1e-4
IMG = 128


def tiny_model(num_classes=4, ema=True):
    """YOLOv5 in the reference's flat schema, narrow: width 0.125, depth
    0.33 (every C3 one bottleneck), ``num_classes`` classes."""
    return dict(type="YOLO", nc=num_classes, depth_multiple=0.33,
                width_multiple=0.125, ema=ema, anchor_t=4.0, boxlg=0.05,
                clslg=0.5, objlg=1.0)


def tiny_inputs(seed=0, img=IMG, batch=2, n_boxes=4, slots=6):
    """``batch`` seeded uint8 tiles and ``n_boxes`` hbbs each of 10-60 px
    (labels 1-4) in ``slots`` padded slots, each box's center kept 0.02
    cells from a cell edge at every stride (the ``near`` masks' cut)."""
    rng = np.random.RandomState(seed)
    tiles = torch.from_numpy(rng.randint(0, 256, (batch, img, img, 3))
                             .astype(np.uint8))
    boxes = np.zeros((batch, slots, 4), np.float32)
    mask = np.zeros((batch, slots), bool)
    labels = np.zeros((batch, slots), np.int32)
    for b in range(batch):
        g = 0
        while g < n_boxes:
            w, h = rng.uniform(10, 60, 2)
            x, y = rng.uniform(1, img - 1 - w), rng.uniform(1, img - 1 - h)
            cx, cy = x + w / 2, y + h / 2
            if min(abs((c / s) % 0.5 - 0.25) for c in (cx, cy)
                   for s in (8, 16, 32)) > 0.23:
                continue
            boxes[b, g] = [x, y, x + w, y + h]
            mask[b, g] = True
            labels[b, g] = rng.randint(1, 5)
            g += 1
    return tiles, dict(hboxes=torch.from_numpy(boxes),
                       gt_mask=torch.from_numpy(mask),
                       labels=torch.from_numpy(labels))


def nms_margin(head, preds):
    """Per image, the smallest gap of a candidate's best confidence from
    the threshold and from the next lower one among the kept, and of a
    same-class pair's IoU from ``nms_iou``: where two come within f32
    rounding, the detections depend on the last bit."""
    from rs_detection_tpu_torch.ops.nms import bbox_overlaps_hbb

    worst = 1.0
    for i in range(preds[0].shape[0]):
        boxes, scores = head.candidates(preds, i)
        best, lab = scores.amax(-1), scores.argmax(-1)
        ok = best > head.conf_thr
        worst = min(worst, (best - head.conf_thr).abs().min().item())
        b = best[ok].sort(descending=True).values
        if len(b) > 1:
            worst = min(worst, (b[:-1] - b[1:]).min().item())
        ob, ol = boxes[ok], lab[ok]
        iou = bbox_overlaps_hbb(ob, ob)
        same = (ol[:, None] == ol[None, :]) & ~torch.eye(
            len(ol), dtype=torch.bool)
        if same.any():
            worst = min(worst, (iou[same] - head.nms_iou).abs().min().item())
    return worst


def synthetic_preds(batch=2, img=IMG, num_classes=4, seed=11, obj=-5.0):
    """Seeded raw head outputs of the three levels at ``img``^2 ([B, H,
    W, 3 x (5 + C)], N(0, 2^2), the objectness logits shifted by ``obj``):
    a trained head's spread of confidences, so that a few dozen pass 0.25
    apart from one another (a random narrow network's outputs are nearly
    the same at every position, ties everywhere in the NMS)."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for s in (8, 16, 32):
        p = 2.0 * torch.randn(batch, img // s, img // s, 3, 5 + num_classes,
                              generator=g)
        p[..., 4] += obj
        out.append(p.reshape(batch, img // s, img // s, -1))
    return out


def run_tiny(device, tiles, targets, steps=3, ema_decay=0.9):
    """The narrow model from seed 3 on ``device``: the losses and their
    gradients at the weights as drawn, ``get_bboxes`` of
    ``synthetic_preds``, then ``steps`` nesterov SGD steps under
    ``CosineAnnealingLRGroup`` with the per-step EMA (``ema_decay``).
    Returns dict(model, losses, grads, pred, steps (per-step losses),
    lrs, params, ema)."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.optims.lr_scheduler import \
        CosineAnnealingLRGroup
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import (ParamEMA,
                                                            train_step)

    model = reg.build_from_cfg(tiny_model(), reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(device)
    x = normalize(tiles.to(device))
    t = {k: v.to(device) for k, v in targets.items()}
    model.train()
    model.zero_grad()
    losses = model.loss(x, t)
    sum(losses.values()).backward()
    grads = {n: p.grad.detach().cpu().clone()
             for n, p in model.named_parameters()}
    with torch.no_grad():
        pred = model.bbox_head.get_bboxes(
            [p.to(device) for p in synthetic_preds()])
    opt = SGD(model.named_parameters(), lr=0.01, momentum=0.937,
              nesterov=True)
    sched = CosineAnnealingLRGroup(max_steps=2, warmup="linear",
                                   warmup_iters=2, warmup_ratio=0.1,
                                   warmup_init_lr_pg=[0.0, 0.0, 0.1],
                                   warmup_initial_momentum=0.8)
    ema = ParamEMA(model, ema_decay)
    hist, lrs = [], []
    for i in range(steps):
        out = train_step(model, opt, sched, x, t, None,
                         epoch=opt.iterations / 2, ema=ema, step=i)
        hist.append({k: float(v) for k, v in out.items()})
        lrs.append(opt.param_groups[0]["lr"])
    return dict(model=model,
                losses={k: float(v.detach()) for k, v in losses.items()},
                grads=grads, pred={k: v.cpu() for k, v in pred.items()},
                steps=hist, lrs=lrs,
                params={n: p.detach().cpu() for n, p in
                        model.named_parameters()},
                ema=dict(zip(ema.names, (s.cpu() for s in ema.shadow))))


def compare(cpu, gpu):
    """Worst differences of two ``run_tiny`` results: the losses and the
    steps' losses (relative), the gradients, parameters and EMA (of
    their largest entry), polys and scores of the valid slots."""
    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp(min=1e-12)).item()

    v = cpu["pred"]["valid"]
    return dict(
        losses=max(abs(gpu["losses"][k] - c) / max(abs(c), 1e-6)
                   for k, c in cpu["losses"].items()),
        grads=max(rel(gpu["grads"][n], g) for n, g in cpu["grads"].items()),
        steps=max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-6)
                  for g, c in zip(gpu["steps"], cpu["steps"]) for k in c),
        params=max(rel(gpu["params"][n], p)
                   for n, p in cpu["params"].items()),
        ema=max(rel(gpu["ema"][n], e) for n, e in cpu["ema"].items()),
        lrs=max(abs(a - b) for a, b in zip(gpu["lrs"], cpu["lrs"])),
        polys=(gpu["pred"]["polys"][v] - cpu["pred"]["polys"][v])
        .abs().max().item(),
        scores=(gpu["pred"]["scores"][v] - cpu["pred"]["scores"][v])
        .abs().max().item())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_tiny_yolo_cuda_matches_cpu(dev):
    """The same detection slots and labels, polygons within 1e-2 px,
    scores within 1e-5, the losses within 1e-4 relative and every
    gradient within 1e-3 of its largest entry (the scatter-max and the
    gathers' backward add in a device-dependent order), three steps'
    losses, parameters and EMA within 1e-4, the rates equal."""
    tiles, targets = tiny_inputs()
    cpu = run_tiny("cpu", tiles, targets)
    gpu = run_tiny(dev, tiles, targets)
    assert torch.equal(cpu["pred"]["valid"], gpu["pred"]["valid"])
    assert torch.equal(cpu["pred"]["labels"], gpu["pred"]["labels"])
    err = compare(cpu, gpu)
    assert err["polys"] <= POLY_ATOL and err["scores"] <= SCORE_ATOL
    assert err["losses"] <= LOSS_RTOL and err["grads"] <= GRAD_RTOL
    assert max(err["steps"], err["params"], err["ema"]) <= STEP_RTOL
    assert err["lrs"] == 0.0
