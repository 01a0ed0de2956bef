"""SSD on a CUDA GPU against the CPU (``python -m pytest -m cuda
--noconftest tests/test_torch_ssd_cuda.py`` on the card; every test here
skips without one): the tiny network's ``predict`` and two SGD steps.
Also the torch-only pieces the CPU tests and ``chip_smoke.py`` share:
the tiny network as a config section, its inputs and its run, a rendered
COCO-format dataset, and the margins that keep f32 rounding from
deciding an assignment or the hard-negative cut."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.ops.nms import bbox_overlaps_hbb
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda

# the card against the CPU, f32: tiny predict (phase 5's), the steps'
# losses (phase 9's)
POLY_ATOL, SCORE_ATOL, LOSS_RTOL = 1e-2, 1e-5, 1e-4
IMG = 96


def tiny_model(num_classes=3, img=IMG):
    """SSD in the zoo's schema (``projects/ssd/configs/ssd300_coco.py``)
    at ``img``^2: VGG-16 (its widths are fixed), the neck with padding 1
    on every extra level, so that none is empty below 272^2 (at 96^2 the
    levels are 12, 6, 3, 2, 2, 2), the head with ``num_classes`` classes
    (and the background), anchors for ``img`` on strides 8-96, 200
    candidates, 50 slots."""
    return dict(
        type="SingleStageDetector",
        backbone=dict(type="SSD_VGG16", input_size=img),
        neck=dict(type="SSDNeck", in_channels=[512, 1024],
                  level_paddings=[1, 1, 1, 1], level_strides=[2, 2, 1, 1],
                  out_channels=[512, 1024, 512, 256, 256, 256]),
        roi_heads=dict(
            type="SSDHead", num_classes=num_classes,
            in_channels=[512, 1024, 512, 256, 256, 256],
            anchor_generator=dict(
                type="SSDAnchorGenerator", basesize_ratio_range=[0.15, 0.9],
                input_size=img, ratios=[[2], [2, 3], [2, 3], [2, 3], [2],
                                        [2]],
                scale_major=False, strides=[8, 16, 32, 48, 48, img]),
            bbox_coder_cfg=dict(type="DeltaXYWHBBoxCoder",
                                target_means=[0.0] * 4,
                                target_stds=[0.1, 0.1, 0.2, 0.2]),
            test_cfg=dict(max_per_img=50, nms=dict(type="nms",
                                                   iou_threshold=0.45),
                          nms_pre=200, score_thr=0.02),
            train_cfg=dict(neg_pos_ratio=3)))


def tiny_inputs(seed=0, img=IMG, batch=2, n_boxes=3, slots=4):
    """``batch`` seeded uint8 tiles and ``n_boxes`` hbbs each of 12-35 px
    (labels 1-3) in ``slots`` padded slots."""
    rng = np.random.RandomState(seed)
    tiles = torch.from_numpy(rng.randint(0, 256, (batch, img, img, 3))
                             .astype(np.uint8))
    boxes = np.zeros((batch, slots, 4), np.float32)
    mask = np.zeros((batch, slots), bool)
    labels = np.zeros((batch, slots), np.int32)
    for b in range(batch):
        for g in range(n_boxes):
            x, y = rng.uniform(2, img - 40, 2)
            w, h = rng.uniform(12, 35, 2)
            boxes[b, g] = [x, y, x + w, y + h]
            mask[b, g] = True
            labels[b, g] = rng.randint(1, 4)
    return tiles, dict(hboxes=torch.from_numpy(boxes),
                       gt_mask=torch.from_numpy(mask),
                       labels=torch.from_numpy(labels))


def assignment_margin(head, hboxes, gt_mask, sizes):
    """The smallest gap, over the batch, between a box's best anchor IoU
    and the next lower one, and between any anchor's best IoU and the
    0.5 thresholds: where two anchors come within f32 rounding of a
    box's best IoU, the low-quality rescue keeps one or both depending on
    the last bit. Exact ties (equal squares around a small box) are the
    same values in every framework."""
    a = head.anchors(sizes, "cpu")
    worst = 1.0
    for b in range(hboxes.shape[0]):
        iou = bbox_overlaps_hbb(a, hboxes[b][gt_mask[b]].float())
        srt = iou.sort(0, descending=True).values
        below = torch.where(srt < srt[:1], srt, -1.0).amax(0)
        worst = min(worst, (srt[0] - below).min().item(),
                    (iou.amax(1) - 0.5).abs().min().item())
    return worst


def mining_margin(head, outs, targets):
    """The relative gap between the last negative the hard-negative
    mining keeps and the first it drops (their cross-entropies): equal
    losses at the cut would pick anchors by rounding."""
    cls_scores, _ = outs
    b = cls_scores[0].shape[0]
    res = head.targets(head.anchors([c.shape[1:3] for c in cls_scores],
                                    cls_scores[0].device), targets)
    cls = torch.cat([c.reshape(b, -1, head.num_classes)
                     for c in cls_scores], 1).float()
    ce = -torch.log_softmax(cls, -1).gather(-1, res.labels[..., None])[..., 0]
    pos = res.labels > 0
    neg = ce[~pos & (res.label_weights > 0)].sort(descending=True).values
    k = int(head.neg_pos_ratio * pos.sum().clamp(min=1))
    return ((neg[k - 1] - neg[k]) / neg[k - 1]).item()


def spread(head):
    """The classifier spread (weights x 60, biases 0), so that the random
    head's scores stand apart (four classes' softmax near 1/4 each would
    rank the candidates by rounding)."""
    with torch.no_grad():
        for i in range(len(head.anchor_gen.base_anchors)):
            getattr(head, f"cls_{i}").weight.mul_(60.0)
            getattr(head, f"cls_{i}").bias.zero_()


def run_tiny(device, tiles, targets, steps=2):
    """The tiny model from seed 3 on ``device``: ``predict`` of ``tiles``
    with the classifier spread, then, from the model as drawn, ``steps``
    SGD steps (clip at 35). Returns (model, predict, per-step losses)."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model = reg.build_from_cfg(tiny_model(), reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(device)
    head = model.bbox_head
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


def render_coco(root, n=4, size=IMG, seed=0, cat_ids=(3, 7, 18),
                objects=3, split="images"):
    """``n`` square ``size``^2 PNG tiles (or, with ``size`` a list of
    ``n`` (w, h), tiles of those sizes) with ``objects`` visible filled
    rectangles each (one colour a class) under ``root/split`` and their
    COCO json ``root/annotations.json``: categories with the ids
    ``cat_ids`` (not 1..K, as COCO's are not), ``bbox`` as [x, y, w, h],
    and one extra ``iscrowd`` box on the first image (dropped by the
    dataset). Returns (images dir, json path)."""
    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    colours = [(230, 60, 40), (40, 200, 230), (240, 220, 60)]
    images, anns = [], []
    sizes = [(size, size)] * n if np.isscalar(size) else list(size)
    for i, (iw, ih) in enumerate(sizes):
        img = np.full((ih, iw, 3), 60, np.uint8)
        img += (rng.rand(ih, iw, 3) * 20).astype(np.uint8)
        for _ in range(objects):
            w, h = rng.uniform(0.15, 0.4, 2) * (iw, ih)
            x, y = rng.uniform(0, iw - w), rng.uniform(0, ih - h)
            c = rng.randint(len(cat_ids))
            img[int(y):int(y + h), int(x):int(x + w)] = colours[c % 3]
            anns.append(dict(id=len(anns) + 1, image_id=100 + i,
                             category_id=int(cat_ids[c]), iscrowd=0,
                             bbox=[float(x), float(y), float(w), float(h)],
                             area=float(w * h)))
        if i == 0:
            anns.append(dict(id=len(anns) + 1, image_id=100, iscrowd=1,
                             category_id=int(cat_ids[0]),
                             bbox=[1.0, 1.0, 10.0, 10.0], area=100.0))
        name = f"img_{i:03d}.png"
        Image.fromarray(img).save(os.path.join(img_dir, name))
        images.append(dict(id=100 + i, file_name=name, width=iw,
                           height=ih))
    path = os.path.join(root, "annotations.json")
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=int(c), name=f"c{c}")
                                   for c in cat_ids]), f)
    return img_dir, path


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_tiny_ssd_cuda_matches_cpu(dev):
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
