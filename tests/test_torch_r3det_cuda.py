"""R3Det on a CUDA GPU against the CPU (``python -m pytest -m cuda
--noconftest tests/test_torch_r3det_cuda.py`` on the card; every test here
skips without one): the tiny network's ``predict`` and two SGD steps, and
the feature-refine gather with its backward. Also the torch-only pieces
the CPU tests and ``chip_smoke.py`` share: the tiny network as a config
section, its inputs and its run, the feature-refine inputs."""

import numpy as np
import pytest
import torch

from rs_detection_tpu_torch.models.networks import \
    r3det  # noqa: F401  (registers the network)
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda

# the card against the CPU, f32: tiny predict (phase 5's), the steps'
# losses (phase 9's); the gather: f32 sums of 4-20 products a value, its
# backward's atomics in another order
POLY_ATOL, SCORE_ATOL, LOSS_RTOL, FR_ATOL = 1e-2, 1e-5, 1e-4, 1e-5


def tiny_model(norm_eval=True):
    """A tiny R3Det in the zoo config's schema: ResNet-18 (running
    statistics unless ``norm_eval`` is False), a 32-wide FPN from C3 with
    ``on_input`` extra convs, a ``RetinaHead`` at 32 channels with two
    convs a branch, 3 classes with the background, 9 anchors a position,
    32 candidates a level and 16 detection slots; two
    ``RRetinaRefineHead`` sections and two ``frm_cfgs`` at 32 channels,
    of which the network builds the first, as in JAX."""
    refine = dict(type="RRetinaRefineHead", num_classes=2, in_channels=32,
                  feat_channels=32, stacked_convs=2,
                  bbox_coder=dict(type="DeltaXYWHABBoxCoder",
                                  target_stds=[1.0] * 5))
    frm = dict(in_channels=32, featmap_strides=[8, 16, 32, 64, 128])
    return dict(
        type="R3Det", backbone=dict(type="ResNet", depth=18,
                                    norm_eval=norm_eval),
        neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                  out_channels=32, start_level=1, num_outs=5,
                  add_extra_convs="on_input"),
        bbox_head=dict(type="RetinaHead", num_classes=3, in_channels=32,
                       feat_channels=32, stacked_convs=2, nms_pre=32,
                       max_per_img=16),
        refine_heads=[refine, dict(refine)], frm_cfgs=[frm, dict(frm)],
        num_refine_stages=2)


def tiny_inputs(seed=7, img=128, axis_aligned=True):
    """Two seeded ``img``^2 tiles and 6 boxes each (the last slot of the
    second padded), labels 1-2; ``axis_aligned`` sets the angles to 0
    (the devices' sines differ in the last bit, and an anchor that ties a
    box's best IoU would change its assignment)."""
    from rs_detection_tpu_torch.flagship import make_targets

    g = torch.Generator().manual_seed(seed)
    tiles = torch.randint(0, 256, (2, img, img, 3), generator=g,
                          dtype=torch.uint8)
    t = make_targets(2, img, 6, g)
    t["gt_mask"][1, 5] = False
    t["labels"] = t["labels"].clamp(max=2)
    if axis_aligned:
        t["rboxes"][..., 4] = 0.0
    return tiles, t


def spread(head):
    """The refine classifier spread (weights x 60, biases 0) so that the
    random head's scores pass the 0.05 threshold."""
    with torch.no_grad():
        head.out_cls.weight.mul_(60.0)
        head.out_cls.bias.zero_()


def run_tiny(device, tiles, targets, steps=2):
    """The tiny model from seed 3 on ``device``: its ``predict`` of
    ``tiles`` with the refine classifier spread, then, from the model as
    drawn, ``steps`` SGD steps (clip at 35). Returns (model, predict,
    per-step losses)."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model = reg.build_from_cfg(tiny_model(), reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(device)
    head = model.refine_head
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


def fr_inputs(seed=0, n=2, h=9, w=11, c=3):
    """Features [N, H, W, C] and boxes [N, H, W, 5] (cx, cy, w, h,
    theta) whose centres span the inside, the (-1, 0] band, the clamped
    last row and column and the outside, and whose sizes carry the
    corners of ``points`` 5 out of the map too
    (``tests/test_torch_parity_fr.py:_case``)."""
    rng = np.random.RandomState(seed)
    feats = rng.randn(n, h, w, c).astype(np.float32)
    boxes = np.stack([rng.uniform(-3.0, w + 3.0, (n, h, w)),
                      rng.uniform(-3.0, h + 3.0, (n, h, w)),
                      rng.uniform(0.5, 12.0, (n, h, w)),
                      rng.uniform(0.5, 12.0, (n, h, w)),
                      rng.uniform(-np.pi, np.pi, (n, h, w))], -1)
    return feats, boxes.astype(np.float32)


def fr_fwd_bwd(device, feats, boxes, scale, points):
    """``feature_refine`` of the inputs on ``device`` and the gradient of
    its weighted sum (weights 0, 1, 2, ... so that it is not uniform)
    with respect to the features, on the CPU."""
    from rs_detection_tpu_torch.ops.fr import feature_refine

    f = torch.as_tensor(feats, device=device).requires_grad_(True)
    out = feature_refine(f, torch.as_tensor(boxes, device=device), scale,
                         points)
    wgt = torch.arange(out.numel(), dtype=torch.float32,
                       device=device).reshape(out.shape)
    (out * wgt).sum().backward()
    return out.detach().cpu(), f.grad.cpu()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_tiny_r3det_cuda_matches_cpu(dev):
    """The same detection slots and labels, polygons within 1e-2 px,
    scores within 1e-5, the four losses of two steps within 1e-4
    relative."""
    tiles, targets = tiny_inputs()
    cpu = run_tiny("cpu", tiles, targets)
    gpu = run_tiny(dev, tiles, targets)
    assert torch.equal(cpu[1]["valid"], gpu[1]["valid"].cpu())
    assert torch.equal(cpu[1]["labels"], gpu[1]["labels"].cpu())
    err = compare(cpu, gpu)
    assert err["polys"] <= POLY_ATOL and err["scores"] <= SCORE_ATOL
    assert err["losses"] <= LOSS_RTOL


@pytest.mark.parametrize("points", [1, 5])
def test_feature_refine_cuda_matches_cpu(dev, points):
    """The gather and its backward (autograd's scatter-add, atomics on the
    card) within 1e-5 of the largest entry."""
    feats, boxes = fr_inputs(seed=points)
    oc, gc = fr_fwd_bwd("cpu", feats, boxes, 0.5, points)
    og, gg = fr_fwd_bwd(dev, feats, boxes, 0.5, points)
    assert (og - oc).abs().max() <= FR_ATOL * oc.abs().max()
    assert (gg - gc).abs().max() <= FR_ATOL * gc.abs().max()
