"""S2ANet on a CUDA GPU against the CPU (``python -m pytest -m cuda
--noconftest tests/test_torch_s2anet_cuda.py`` on the card; every test
here skips without one): the tiny network's ``predict`` and two SGD
steps, the deformable convolution's forward and backward, the ORN ops,
rotated NMS and the blocked rotated IoU. Also the torch-only pieces the
CPU tests and ``chip_smoke.py`` share: the tiny S2ANet of
``tests/test_s2anet.py:16-27`` as a config section, its run and its
inputs.

Autograd's backward of the deformable gather adds into the input with
atomics on the card, so two backward passes there may differ in the
last bits: the card is held to the CPU with tolerances, never bits."""

import pytest
import torch

from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda

# the card against the CPU, f32: tiny predict (phase 5's), two steps'
# losses (phase 9's); the deformable conv's forward and its gradients
# (sums of up to K*K*C products and atomic adds in another order)
POLY_ATOL, SCORE_ATOL, LOSS_RTOL = 1e-2, 1e-5, 1e-4
DCN_RTOL = 1e-5


def tiny_model(zoo_freezing=True, num_classes=4):
    """``tests/test_s2anet.py``'s tiny S2ANet as a config section:
    ResNet-18 (with ``zoo_freezing`` the zoo's ``frozen_stages=1`` and
    running statistics), a 32-wide FPN with ``on_input`` extra convs,
    the 32-wide head on strides 4-64 with 32 candidates a level and 16
    detection slots."""
    bb = dict(type="ResNet", depth=18, norm_eval=zoo_freezing)
    if zoo_freezing:
        bb["frozen_stages"] = 1
    return dict(type="S2ANet", backbone=bb,
                neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                          out_channels=32, num_outs=5,
                          add_extra_convs="on_input"),
                bbox_head=dict(type="S2ANetHead", num_classes=num_classes,
                               in_channels=32, feat_channels=32,
                               anchor_strides=[4, 8, 16, 32, 64],
                               nms_pre=32, max_per_img=16))


def tiny_inputs(seed=35):
    """Two seeded 128^2 tiles and 6 axis-aligned boxes each (as
    ``chip_smoke.py``'s phase 9: the low-quality rescue keeps every
    anchor that ties a box's best IoU, and the devices' sines differ in
    the last bit)."""
    from rs_detection_tpu_torch.flagship import make_targets

    g = torch.Generator().manual_seed(seed)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    targets = make_targets(2, 128, 6, g)
    targets["rboxes"][..., 4] = 0.0
    targets["labels"] = targets["labels"].clamp(max=3)
    return tiles, targets


def run_tiny(device, tiles, targets, steps=2):
    """The tiny model from seed 3 on ``device``: its ``predict`` of
    ``tiles`` with the ODM classifier's three convs scaled by 10 and its
    bias at -1 (so that the random head detects, with scores 0.53-0.96 at
    least 2e-4 apart), then, from the model as drawn, the losses of
    ``steps`` SGD steps (the scaled classifier's loss of ~100 would make
    them chaotic)."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model = reg.build_from_cfg(tiny_model(), reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(device)
    head = model.bbox_head
    drawn = {k: v.clone() for k, v in head.state_dict().items()}
    with torch.no_grad():
        for name in ("odm_cls_0", "odm_cls_1", "odm_cls_out"):
            getattr(head, name).weight.mul_(10.0)
        head.odm_cls_out.bias.fill_(-1.0)
    pred = model.eval().predict(normalize(tiles.to(device)))
    head.load_state_dict(drawn)
    opt = SGD(model.parameters(), lr=0.01, momentum=0.9,
              grad_clip=dict(max_norm=35))
    sched = StepLR([8], warmup="linear", warmup_iters=4, warmup_ratio=0.25)
    losses = []
    for step in range(steps):
        out = train_step(model, opt, sched, normalize(tiles.to(device)),
                         {k: v.to(device) for k, v in targets.items()},
                         None, epoch=opt.iterations / 2)
        losses.append({k: float(v) for k, v in out.items()})
    return model, pred, losses


def dcn_inputs(device, n=2, c=64, h=40, w=48, cout=32, seed=36):
    """A deformable conv's inputs at S2ANet's form (3x3, stride 1, pad
    1): features, offsets of up to a few pixels (some taps outside the
    image), an OIHW weight."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g)
    off = torch.randn(n, h, w, 18, generator=g) * 3
    wt = torch.randn(cout, c, 3, 3, generator=g) * 0.05
    return [t.to(device) for t in (x, off, wt)]


def dcn_fwd_bwd(x, off, wt):
    """The deformable conv's output and the gradients of sum(out * r)
    for the input and the weight (r seeded)."""
    from rs_detection_tpu_torch.ops.deform_conv import deform_conv2d

    x = x.detach().clone().requires_grad_()
    wt = wt.detach().clone().requires_grad_()
    out = deform_conv2d(x, off, wt)
    r = torch.randn(out.shape, generator=torch.Generator().manual_seed(37))
    (out * r.to(out.device)).sum().backward()
    return out.detach(), x.grad, wt.grad


def nms_inputs(device, n=3000, classes=15, seed=38):
    """One tile's decode output: ``n`` boxes in clusters over 1024^2 and
    a background column then ``classes`` sigmoid scores."""
    g = torch.Generator().manual_seed(seed)
    centres = torch.rand(60, 2, generator=g) * 1024
    pick = torch.randint(0, 60, (n,), generator=g)
    boxes = torch.cat([centres[pick] + torch.randn(n, 2, generator=g) * 20,
                       torch.rand(n, 2, generator=g) * 60 + 8,
                       (torch.rand(n, 1, generator=g) - 0.5) * 3], 1)
    scores = torch.cat([torch.zeros(n, 1),
                        torch.rand(n, classes, generator=g) ** 3], 1)
    return boxes.to(device), scores.to(device)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_tiny_s2anet_cuda_matches_cpu(dev):
    """The same valid slots and labels, polys within 1e-2 px, scores
    within 1e-5, the losses of two SGD steps within 1e-4 relative."""
    tiles, targets = tiny_inputs()
    _, p_cpu, l_cpu = run_tiny("cpu", tiles, targets)
    _, p_gpu, l_gpu = run_tiny(dev, tiles, targets)
    assert p_cpu["valid"].sum() > 4
    assert torch.equal(p_cpu["valid"], p_gpu["valid"].cpu())
    assert torch.equal(p_cpu["labels"], p_gpu["labels"].cpu())
    assert (p_gpu["polys"].cpu() - p_cpu["polys"]).abs().max() <= POLY_ATOL
    assert (p_gpu["scores"].cpu() - p_cpu["scores"]).abs().max() <= SCORE_ATOL
    for g, c in zip(l_gpu, l_cpu):
        for k in c:
            assert abs(g[k] - c[k]) <= LOSS_RTOL * max(abs(c[k]), 1e-6), k


def test_deform_conv_cuda_matches_cpu(dev):
    """Forward and both gradients within 1e-5 of each tensor's largest
    entry."""
    got = dcn_fwd_bwd(*dcn_inputs(dev))
    want = dcn_fwd_bwd(*dcn_inputs("cpu"))
    for a, b in zip(got, want):
        assert (a.cpu() - b).abs().max() <= DCN_RTOL * b.abs().max()


def test_orn_cuda_equals_cpu(dev):
    from rs_detection_tpu_torch.models.roi_heads.s2anet_head import ORConv2d
    from rs_detection_tpu_torch.ops import orn

    m = ORConv2d(64, 8)
    with torch.no_grad():
        m.weight.normal_(generator=torch.Generator().manual_seed(39))
    assert torch.equal(m.to(dev).rotated_weight().cpu(),
                       m.cpu().rotated_weight())
    x = torch.randn(2, 9, 10, 64)
    assert torch.equal(orn.rotation_invariant_pooling(x.to(dev)).cpu(),
                       orn.rotation_invariant_pooling(x))


def test_multiclass_nms_rotated_cuda_matches_cpu(dev):
    """One tile's 3,000 candidates: the same kept slots and labels (no
    candidate pair's IoU lies within 2.5e-5 of the 0.1 threshold on the
    CPU, and the devices' IoUs differ by ~4e-6), dets within 1e-3 px
    (measured equal on an H100)."""
    from rs_detection_tpu_torch.ops.nms_rotated import \
        multiclass_nms_rotated_jit

    b, s = nms_inputs("cpu")
    ref = multiclass_nms_rotated_jit(b, s, 0.05, 0.1)
    got = multiclass_nms_rotated_jit(b.to(dev), s.to(dev), 0.05, 0.1)
    assert torch.equal(got[2].cpu(), ref[2]) and ref[2].sum() > 100
    assert torch.equal(got[1].cpu(), ref[1])
    assert (got[0].cpu() - ref[0]).abs().max() <= 1e-3


def test_blocked_iou_cuda(dev):
    """Blocks of 1, 1,000 and 2^21 pairs give the same bits on the card;
    the card is within 1e-5 of the CPU."""
    from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated

    b, _ = nms_inputs(dev, n=900)
    whole = box_iou_rotated(b, b[:311])
    for block in (1, 1000):
        assert torch.equal(box_iou_rotated(b, b[:311], pair_block=block),
                           whole)
    cpu = box_iou_rotated(b.cpu(), b[:311].cpu())
    assert (whole.cpu() - cpu).abs().max() <= 1e-5
