"""RoI-Transformer and FasterRCNN-OBB on a CUDA GPU against the CPU
(``python -m pytest -m cuda --noconftest tests/test_torch_roitrans_cuda.py``
on the card; every test here skips without one): the tiny cascades'
``predict`` and two SGD steps, K1 on the stage-2 rois (against its plain
version and bit for bit across launches), and the horizontal RoIAlign.
Also the torch-only pieces the CPU tests and ``chip_smoke.py`` share: the
tiny configs of ``tests/test_networks_smoke.py:94-125`` and a sampler
that draws nothing."""

import pytest
import torch

from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
from rs_detection_tpu_torch.models.networks import \
    roi_transformer  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.ops import box_ops as B
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda

TINY_RPN = dict(type="RPNHead", in_channels=32, feat_channels=32,
                nms_pre=64, nms_post=32)
TINY_HEAD = dict(type="RoITransformerHead", num_classes=15, in_channels=32,
                 sampler_num=16, pos_fraction=0.25,
                 featmap_strides=[4, 8, 16, 32])
TINY_KINDS = {"roitrans": ("RoITransformer", {}),
              "roitrans_kfiou": ("RoITransformer", dict(reg_loss="kfiou")),
              "faster_rcnn_obb": ("FasterRCNNOBB", {})}


def tiny_model(kind, zoo_freezing=False):
    """The model section of ``tests/test_networks_smoke.py``'s
    RoI-Transformer, KFIoU RoI-Transformer or FasterRCNN-OBB: ResNet-18
    (batch statistics in training; with ``zoo_freezing`` the zoo's
    ``frozen_stages=1`` and running statistics, as
    ``chip_smoke.py:resnet_tiny_model``), a 32-wide FPN with ``on_input``
    extra convs, a 32-wide RPN (64 / 32 proposals) and the cascade head
    with 16 roi slots per image."""
    net, head = TINY_KINDS[kind]
    bb = dict(type="ResNet", depth=18, norm_eval=zoo_freezing)
    if zoo_freezing:
        bb["frozen_stages"] = 1
    return dict(type=net, backbone=bb,
                neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                          out_channels=32, num_outs=5,
                          add_extra_convs="on_input"),
                rpn=dict(TINY_RPN), bbox_head=dict(TINY_HEAD, **head))


def first_k_sample(sampler, assigned, generator=None):
    """``RandomSampler.sample`` without the draw: the first positives by
    index up to ``num * pos_fraction``, then the first negatives up to
    ``num``. Both devices (and the JAX package, in its form) then pick
    the same slots, where no sampler takes every candidate (a cascade's
    stage 2 has ``num`` + G candidates for ``num`` slots)."""
    pos = assigned > 0
    pos = pos & (pos.cumsum(-1) <= int(sampler.num * sampler.pos_fraction))
    neg = assigned == 0
    room = sampler.num - pos.sum(-1, keepdim=True)
    return pos, neg & (neg.cumsum(-1) <= room)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def run_tiny(kind, device, tiles, targets, steps=2):
    """The tiny model with the zoo's freezing from seed 3 on ``device``:
    its ``predict`` of ``tiles`` and the losses of ``steps`` SGD steps
    (first-k sampling). Batch statistics of 2 tiles move the second
    step's losses by up to 2e-2 between the devices (measured on an
    H100): f32 sums in another order, through train-mode norms of as few
    as 2 x 4 x 4 values."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model = reg.build_from_cfg(tiny_model(kind, zoo_freezing=True),
                               reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(device)
    pred = model.eval().predict(normalize(tiles.to(device)))
    opt = SGD(model.parameters(), lr=0.01, momentum=0.9,
              grad_clip=dict(max_norm=35))
    sched = StepLR([8], warmup="linear", warmup_iters=4, warmup_ratio=0.25)
    losses = []
    for step in range(steps):
        out = train_step(model, opt, sched, normalize(tiles.to(device)),
                         {k: v.to(device) for k, v in targets.items()},
                         torch.Generator(device=device).manual_seed(step),
                         epoch=opt.iterations / 2)
        losses.append({k: float(v) for k, v in out.items()})
    return model, pred, losses


def tiny_inputs(seed=32):
    from rs_detection_tpu_torch.flagship import make_targets

    g = torch.Generator().manual_seed(seed)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    targets = make_targets(2, 128, 6, g)
    # axis-aligned, as chip_smoke.py's phase 9 (the RPN's tie-keeping
    # rescue)
    targets["rboxes"][..., 4] = 0.0
    targets["hboxes"] = B.obb2hbb(targets["rboxes"])
    return tiles, targets


@pytest.mark.parametrize("kind", sorted(TINY_KINDS))
def test_tiny_cascade_cuda_matches_cpu(dev, kind, monkeypatch):
    """CUDA (K1 / K3 in stage 2) against the CPU (plain versions), f32:
    the same valid proposals, polys within 1e-2 px and scores within
    1e-5, losses of two SGD steps within 1e-4 relative."""
    monkeypatch.setattr(RandomSampler, "sample", first_k_sample)
    tiles, targets = tiny_inputs()
    _, p_cpu, l_cpu = run_tiny(kind, "cpu", tiles, targets)
    _, p_gpu, l_gpu = run_tiny(kind, dev, tiles, targets)
    assert torch.equal(p_cpu["valid"], p_gpu["valid"].cpu())
    assert (p_gpu["polys"].cpu() - p_cpu["polys"]).abs().max() <= 1e-2
    assert (p_gpu["scores"].cpu() - p_cpu["scores"]).abs().max() <= 1e-5
    for g, c in zip(l_gpu, l_cpu):
        for k in c:
            assert abs(g[k] - c[k]) <= 1e-4 * max(abs(c[k]), 1e-6), (k, g, c)


def test_k1_on_stage2_rois(dev):
    """The rotated rois stage 1 decodes (one tiny predict on the card):
    K1 within 1e-4 of its plain version and the same bits twice."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.models.roi_extractors import \
        oriented_single_level as ext
    from rs_detection_tpu_torch.ops import roi_align as ra

    seen = []
    call = ext.roi_align_rotated_pyramid

    def capture(feats, rois, *a, **kw):
        seen.append(([f.clone() for f in feats], rois.clone()))
        return call(feats, rois, *a, **kw)

    model = reg.build_from_cfg(tiny_model("roitrans"), reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    tiles, _ = tiny_inputs()
    ext.roi_align_rotated_pyramid = capture
    try:
        model.to(dev).eval().predict(normalize(tiles.to(dev)))
    finally:
        ext.roi_align_rotated_pyramid = call
    (feats, rois), = seen
    a = ra.roi_align_rotated_pyramid_cuda(feats, rois)
    b = ra.roi_align_rotated_pyramid_cuda(feats, rois)
    ref = ra.roi_align_rotated_pyramid_reference(feats, rois)
    assert torch.equal(a, b)
    assert (a - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_horizontal_roi_align_cuda_matches_cpu(dev):
    """The plain horizontal RoIAlign and its backward on the card against
    the CPU at the full-width head's shapes (C = 256)."""
    from rs_detection_tpu_torch.models.roi_extractors.oriented_single_level \
        import SingleRoIExtractor

    g = torch.Generator().manual_seed(5)
    feats = [torch.randn(2, 256 // s, 256 // s, 256, generator=g)
             for s in (4, 8, 16, 32)]
    # sides of 1-665 px: rois at all four levels
    xy = torch.rand(3000, 2, generator=g) * 240
    wh = torch.exp(torch.rand(3000, 2, generator=g) * 6.5)
    rois = torch.cat([torch.randint(0, 2, (3000, 1), generator=g).float(),
                      xy, xy + wh], 1)
    grad = torch.randn(3000, 7, 7, 256, generator=g)
    out = {}
    for d in ("cpu", dev):
        fs = [f.to(d, copy=True).requires_grad_() for f in feats]
        y = SingleRoIExtractor()(fs, rois.to(d))
        (y * grad.to(d)).sum().backward()
        out[str(d)] = (y.detach().cpu(), [f.grad.cpu() for f in fs])
    (y_c, g_c), (y_g, g_g) = out["cpu"], out[str(dev)]
    assert (y_g - y_c).abs().max() <= 1e-5 * y_c.abs().max()
    for a, b in zip(g_g, g_c):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()
