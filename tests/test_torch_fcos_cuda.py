"""FCOS on a CUDA GPU against the CPU (``python -m pytest -m cuda
--noconftest tests/test_torch_fcos_cuda.py`` on the card; every test here
skips without one): the tiny network's ``predict`` and two SGD steps,
and the poly-IoU loss with its gradient. Also the torch-only pieces the
CPU tests and ``chip_smoke.py`` share: the tiny network as a config
section, its inputs and its run, the box pairs of the poly-IoU tests and
the margins that keep f32 rounding from deciding."""

import numpy as np
import pytest
import torch

from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.ops import box_ops as B
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda

# the card against the CPU, f32: tiny predict (phase 5's), the steps'
# losses (phase 9's)
POLY_ATOL, SCORE_ATOL, LOSS_RTOL = 1e-2, 1e-5, 1e-4


def tiny_model(norm_eval=True):
    """``tests/test_golden_loss.py:build_fcos``'s network as a config
    section: ResNet-18 (running statistics unless ``norm_eval`` is
    False), a 32-wide FPN from C2 with ``on_input`` extra convs, the
    FCOS head at 32 channels with two GroupNorm convs a tower, 3
    classes, strides 4-64 with their regress ranges, 32 candidates a
    level, 16 detection slots and the configs' centerness factor 0.5."""
    return dict(
        type="FCOS", backbone=dict(type="ResNet", depth=18,
                                   norm_eval=norm_eval),
        neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                  out_channels=32, num_outs=5, add_extra_convs="on_input"),
        bbox_head=dict(type="FCOSHead", num_classes=3, in_channels=32,
                       feat_channels=32, stacked_convs=2,
                       strides=[4, 8, 16, 32, 64],
                       regress_ranges=[[-1, 16], [16, 32], [32, 64],
                                       [64, 128], [128, 1e8]],
                       nms_pre=32, max_per_img=16, centerness_factor=0.5))


def tiny_inputs(seed=7, img=64, axis_aligned=True, offset=0.0):
    """Two seeded ``img``^2 tiles and 6 boxes each (the last slot of the
    second padded), labels 1-3, every box moved by ``offset`` px in x and
    y. ``axis_aligned`` sets the angles to 0: the devices' sines differ in
    the last bit, and a point on a box's edge would change side."""
    from rs_detection_tpu_torch.flagship import make_targets

    g = torch.Generator().manual_seed(seed)
    tiles = torch.randint(0, 256, (2, img, img, 3), generator=g,
                          dtype=torch.uint8)
    t = make_targets(2, img, 6, g)
    t["gt_mask"][1, 5] = False
    t["labels"] = t["labels"].clamp(max=3)
    t["rboxes"][..., :2] += offset
    if axis_aligned:
        t["rboxes"][..., 4] = 0.0
    return tiles, t


def box_pairs(n, seed):
    """``n`` aligned (pred, target) obb pairs: targets 8-60 px at any
    angle, each pred the target moved by up to a third of its size,
    resized by 0.7-1.4 and turned by up to 0.5 rad."""
    rng = np.random.RandomState(seed)
    t = np.stack([rng.uniform(0, 200, n), rng.uniform(0, 200, n),
                  rng.uniform(8, 60, n), rng.uniform(8, 60, n),
                  rng.uniform(-np.pi / 2, np.pi / 2, n)], -1)
    side = t[:, 2:4].min(1, keepdims=True)
    p = t + np.concatenate([rng.uniform(-1, 1, (n, 2)) * side / 3,
                            np.zeros((n, 3))], 1)
    p[:, 2:4] *= rng.uniform(0.7, 1.4, (n, 2))
    p[:, 4] += rng.uniform(-0.5, 0.5, n)
    return p.astype(np.float32), t.astype(np.float32)


def decision_margin(pred, target, eps=1e-6):
    """Per pair, the smallest distance of any discrete decision of
    ``poly_intersection`` from its threshold, relative: the crossing
    parameters from 0 and 1, |num| from ``eps`` (relative to eps), the
    triangle-fan inside test from its relative 1e-3. Values and gradients
    are compared on pairs where it is above 1e-3: there f32 rounding
    (~1e-6 relative) decides nothing."""
    p = B.obb2poly(torch.as_tensor(pred).double()).reshape(-1, 4, 2)
    t = B.obb2poly(torch.as_tensor(target).double()).reshape(-1, 4, 2)
    l1 = torch.cat([p, torch.roll(p, -1, 1)], 2)[:, :, None]
    l2 = torch.cat([t, torch.roll(t, -1, 1)], 2)[:, None]
    x1, y1, x2, y2 = l1.unbind(-1)
    x3, y3, x4, y4 = l2.unbind(-1)
    num = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    tm = ((x1 - x3) * (y3 - y4) - (y1 - y3) * (x3 - x4)) / num
    um = ((x2 - x1) * (y1 - y3) - (y2 - y1) * (x1 - x3)) / num
    cross = torch.stack([tm.abs(), (tm - 1).abs(), um.abs(),
                         (um - 1).abs()]).amin(0).flatten(1).amin(1)
    a1 = torch.as_tensor(pred).double()[:, 2] * torch.as_tensor(pred).double()[:, 3]
    a2 = torch.as_tensor(target).double()[:, 2] * torch.as_tensor(target).double()[:, 3]
    tri1 = 0.5 * ((x3 - x1) * (y4 - y1) - (y3 - y1) * (x4 - x1)).abs()
    tri2 = 0.5 * ((x1 - x3) * (y2 - y3) - (x2 - x3) * (y1 - y3)).abs()
    in1 = ((tri1.sum(-1) - a2[:, None]).abs() / a2[:, None] - 1e-3).abs()
    in2 = ((tri2.sum(-2) - a1[:, None]).abs() / a1[:, None] - 1e-3).abs()
    return torch.stack([cross, (num.abs() / eps - 1).abs().flatten(
        1).amin(1), in1.amin(1) / 1e-3, in2.amin(1) / 1e-3]).amin(0)


def target_margin(head, points, strides, gt, mask):
    """The smallest distance, in px, of any comparison of the dense
    targets from its threshold: the edge distances from 0, the offsets
    from the centre-sampling radius, the largest distance from the
    regress ranges, and between two boxes' areas in one image."""
    g = B.mintheta_obb(gt.double())
    c, s = torch.cos(g[..., 4])[:, None], torch.sin(g[..., 4])[:, None]
    off = points.double()[None, :, None] - g[:, None, :, :2]
    ox = c * off[..., 0] + s * off[..., 1]
    oy = -s * off[..., 0] + c * off[..., 1]
    w2, h2 = g[:, None, :, 2] / 2, g[:, None, :, 3] / 2
    d = torch.stack([w2 + ox, h2 + oy, w2 - ox, h2 - oy], -1)
    r = (strides.double() * head.center_sample_radius)[None, :, None]
    lo = torch.tensor([r_[0] for r_ in head.regress_ranges],
                      dtype=torch.float64)
    hi = torch.tensor([r_[1] for r_ in head.regress_ranges],
                      dtype=torch.float64)
    level = torch.tensor([head.strides.index(int(s_)) for s_ in strides])
    maxd = d.amax(-1)
    live = mask[:, None, :].expand_as(maxd)
    gaps = [d.abs().amin(-1), (ox.abs() - r).abs(), (oy.abs() - r).abs(),
            (maxd - lo[level][None, :, None]).abs(),
            (maxd - hi[level][None, :, None]).abs()]
    areas = g[..., 2] * g[..., 3]
    da = min((((a[:, None] - a[None]).abs()
               + torch.eye(len(a)) * 1e9).min().item())
             for a in (areas[i][mask[i]] for i in range(len(g))))
    return min(min(x[live].min().item() for x in gaps), da)


def poly_loss_inputs(n=4096, seed=3):
    """Box pairs of ``box_pairs`` whose decision margin is above 1e-3,
    and a weight each."""
    pred, target = box_pairs(n, seed)
    keep = (decision_margin(pred, target) > 1e-3).numpy()
    pred, target = pred[keep], target[keep]
    w = np.random.RandomState(seed + 1).rand(len(pred)).astype(np.float32)
    return pred, target, w


def poly_loss_fwd_bwd(device, pred, target, w, giou=False):
    """The weighted poly-IoU (or GIoU) loss of the pairs on ``device`` and
    its gradient with respect to the predictions, on the CPU."""
    from rs_detection_tpu_torch.models.losses.poly_iou_loss import (
        poly_giou_loss, poly_iou_loss)

    p = torch.as_tensor(pred, device=device).requires_grad_(True)
    w = torch.as_tensor(w, device=device)
    fn = poly_giou_loss if giou else poly_iou_loss
    loss = fn(p, torch.as_tensor(target, device=device), weight=w,
              avg_factor=w.sum())
    loss.backward()
    return loss.detach().cpu(), p.grad.cpu()


def spread(head):
    """The classifier spread (weights x 60, biases 0) so that the random
    head's scores pass the 0.05 threshold."""
    with torch.no_grad():
        head.conv_cls.weight.mul_(60.0)
        head.conv_cls.bias.zero_()


def run_tiny(device, tiles, targets, steps=2):
    """The tiny model from seed 3 (the distances' bias at 3) on
    ``device``: its ``predict`` of ``tiles`` with the classifier spread,
    then, from the model as drawn, ``steps`` SGD steps (clip at 35).
    Returns (model, predict, per-step losses)."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model = reg.build_from_cfg(tiny_model(), reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    head = model.bbox_head
    with torch.no_grad():
        # object-sized boxes (distances 3 strides), as a trained head's: a
        # random head's 1-px boxes inside 30-px ones lose ~1e-4 of the
        # poly-IoU loss to f32 cancellation, differently on each device
        head.conv_reg.bias.fill_(3.0)
    model.to(device)
    drawn = {k: v.clone() for k, v in head.state_dict().items()}
    spread(head)
    pred = model.eval().predict(normalize(tiles.to(device)))
    head.load_state_dict(drawn)
    opt = SGD(model.named_parameters(), lr=0.01, momentum=0.9,
              weight_decay=1e-4, grad_clip=dict(max_norm=35))
    sched = StepLR([8], warmup="linear", warmup_iters=4, warmup_ratio=0.25)
    losses = []
    for _ in range(steps):
        out = train_step(model, opt, sched, normalize(tiles.to(device)),
                         {k: v.to(device) for k, v in targets.items()},
                         None, epoch=opt.iterations / 2)
        losses.append({k: float(v) for k, v in out.items()})
    return model, pred, losses


def compare(cpu, gpu):
    """Worst differences of two ``run_tiny`` results: polys and scores of
    the valid slots, losses (relative)."""
    (_, p_c, l_c), (_, p_g, l_g) = cpu, gpu
    v = p_c["valid"]
    return dict(
        polys=(p_g["polys"].cpu()[v] - p_c["polys"][v]).abs().max().item(),
        scores=(p_g["scores"].cpu()[v] - p_c["scores"][v]).abs().max().item(),
        losses=max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-6)
                   for g, c in zip(l_g, l_c) for k in c))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_tiny_fcos_cuda_matches_cpu(dev):
    """The same detection slots and labels, polygons within 1e-2 px,
    scores within 1e-5, the losses of two steps within 1e-4 relative."""
    tiles, targets = tiny_inputs()
    cpu = run_tiny("cpu", tiles, targets)
    gpu = run_tiny(dev, tiles, targets)
    assert torch.equal(cpu[1]["valid"], gpu[1]["valid"].cpu())
    assert torch.equal(cpu[1]["labels"], gpu[1]["labels"].cpu())
    err = compare(cpu, gpu)
    assert err["polys"] <= POLY_ATOL and err["scores"] <= SCORE_ATOL
    assert err["losses"] <= LOSS_RTOL


@pytest.mark.parametrize("giou", [False, True])
def test_poly_iou_loss_cuda_matches_cpu(dev, giou):
    """The weighted loss within 1e-5 relative, its gradient within 1e-5
    of the largest entry, on pairs held away from every decision."""
    pred, target, w = poly_loss_inputs()
    lc, gc = poly_loss_fwd_bwd("cpu", pred, target, w, giou)
    lg, gg = poly_loss_fwd_bwd(dev, pred, target, w, giou)
    assert abs(lg.item() - lc.item()) <= 1e-5 * abs(lc.item())
    assert (gg - gc).abs().max() <= 1e-5 * gc.abs().max()
