"""Gliding Vertex on a CUDA GPU against the CPU (``python -m pytest -m
cuda --noconftest tests/test_torch_gliding_cuda.py`` on the card; every
test here skips without one): the tiny network's ``predict`` and two
SGD steps, and the coders on axis-aligned quads, whose tied vertices
must resolve as on the CPU. Also the torch-only pieces that the CPU
tests and ``chip_smoke.py`` share: the tiny network as a config section,
its run and its inputs."""

import pytest
import torch

from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
from rs_detection_tpu_torch.models.networks import \
    gliding_vertex  # noqa: F401  (registers the network)
from rs_detection_tpu_torch.ops import box_ops as B
from rs_detection_tpu_torch.utils import registry as reg
from test_torch_roitrans_cuda import first_k_sample

pytestmark = pytest.mark.cuda

# the card against the CPU, f32: tiny predict (phase 5's), two steps'
# losses (phase 9's)
POLY_ATOL, SCORE_ATOL, LOSS_RTOL = 1e-2, 1e-5, 1e-4


def tiny_model():
    """A tiny Gliding Vertex: ResNet-18 with the zoo's ``frozen_stages=1``
    and running statistics, a 32-wide FPN, the 32-wide hbb RPN (64 / 32
    proposals) and the head with 64-wide FCs and 16 roi slots."""
    return dict(
        type="GlidingVertex",
        backbone=dict(type="ResNet", depth=18, frozen_stages=1,
                      norm_eval=True),
        neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                  out_channels=32, num_outs=5),
        rpn=dict(type="GlidingRPNHead", in_channels=32, feat_channels=32,
                 nms_pre=64, nms_post=32),
        bbox_head=dict(type="GlidingHead", num_classes=15, in_channels=32,
                       fc_out_channels=64,
                       sampler=dict(type="RandomSampler", num=16,
                                    pos_fraction=0.25,
                                    add_gt_as_proposals=True),
                       bbox_roi_extractor=dict(
                           type="SingleRoIExtractor", out_channels=32,
                           featmap_strides=[4, 8, 16, 32],
                           roi_layer=dict(type="ROIAlign", output_size=7,
                                          sampling_ratio=2))))


def tiny_inputs(seed=38):
    """Two seeded 128^2 tiles and 6 axis-aligned boxes each (as
    ``chip_smoke.py``'s phase 9: the RPN's low-quality rescue keeps
    every anchor that ties a box's best IoU, and the devices' sines
    differ in the last bit), with their hbbs and corner quads."""
    from rs_detection_tpu_torch.flagship import make_targets

    g = torch.Generator().manual_seed(seed)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    targets = make_targets(2, 128, 6, g)
    targets["rboxes"][..., 4] = 0.0
    targets["hboxes"] = B.obb2hbb(targets["rboxes"])
    targets["polys"] = B.hbb2poly(targets["hboxes"])
    return tiles, targets


def run_tiny(device, tiles, targets, steps=2):
    """The tiny model from seed 3 on ``device``: its ``predict`` of
    ``tiles``, then the losses of ``steps`` SGD steps; both samplers
    take the first candidates by index (``first_k_sample``)."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import SGD
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model = reg.build_from_cfg(tiny_model(), reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(device)
    pred = model.eval().predict(normalize(tiles.to(device)))
    opt = SGD(model.parameters(), lr=0.01, momentum=0.9,
              grad_clip=dict(max_norm=35))
    sched = StepLR([8], warmup="linear", warmup_iters=4, warmup_ratio=0.25)
    sample = RandomSampler.sample
    RandomSampler.sample = first_k_sample
    try:
        losses = []
        for _ in range(steps):
            out = train_step(model, opt, sched, normalize(tiles.to(device)),
                             {k: v.to(device) for k, v in targets.items()},
                             None, epoch=opt.iterations / 2)
            losses.append({k: float(v) for k, v in out.items()})
    finally:
        RandomSampler.sample = sample
    return model, pred, losses


def aligned_quads(n=4096, seed=39):
    """``n`` axis-aligned quads in all four starting corners and both
    windings: every side has two tied vertices."""
    g = torch.Generator().manual_seed(seed)
    lt = torch.rand(n, 2, generator=g) * 900
    hbb = torch.cat([lt, lt + torch.rand(n, 2, generator=g) * 120 + 2], 1)
    pts = B.hbb2poly(hbb).reshape(n, 4, 2)
    shift = torch.randint(0, 4, (n,), generator=g)
    idx = (torch.arange(4)[None] + shift[:, None]) % 4
    flip = torch.rand(n, generator=g) < 0.5
    idx = torch.where(flip[:, None], idx.flip(1), idx)
    return torch.gather(pts, 1, idx[..., None].expand(-1, -1, 2)).reshape(
        n, 8)


def ratio_bound(quads):
    """A bound on ``GVRatioCoder``'s f32 error between two devices: the
    shoelace sum's 8 products of coordinates up to M = max|x|, each
    rounded (or fused into an FMA on the card) and summed, err(2 area) <=
    16 M^2 2^-24, over the hbb's area; plus the quotient's rounding."""
    m = quads.abs().amax(-1)
    hbb = B.poly2hbb(quads)
    h_area = (hbb[:, 2] - hbb[:, 0]) * (hbb[:, 3] - hbb[:, 1])
    return (8 * m * m * 2.0 ** -24 / h_area + 2.0 ** -23)[:, None]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def test_tiny_gliding_cuda_matches_cpu(dev):
    """The same valid proposals, quads within 1e-2 px and scores within
    1e-5, the losses of two SGD steps within 1e-4 relative."""
    tiles, targets = tiny_inputs()
    _, p_cpu, l_cpu = run_tiny("cpu", tiles, targets)
    _, p_gpu, l_gpu = run_tiny(dev, tiles, targets)
    assert torch.equal(p_cpu["valid"], p_gpu["valid"].cpu())
    assert (p_gpu["polys"].cpu() - p_cpu["polys"]).abs().max() <= POLY_ATOL
    assert (p_gpu["scores"].cpu() - p_cpu["scores"]).abs().max() <= SCORE_ATOL
    for g, c in zip(l_gpu, l_cpu):
        for k in c:
            assert abs(g[k] - c[k]) <= LOSS_RTOL * max(abs(c[k]), 1e-6), k


def test_coders_on_aligned_quads_equal_the_cpu(dev):
    """``GVFixCoder`` / ``GVRatioCoder`` on 4096 axis-aligned quads in
    every vertex order: the card's glides equal the CPU's bit for bit
    (the first tied vertex on both), the ratios within ``ratio_bound``."""
    from rs_detection_tpu_torch.models.boxes.coder import (GVFixCoder,
                                                           GVRatioCoder)

    q = aligned_quads()
    assert torch.equal(GVFixCoder().encode(q.to(dev)).cpu(),
                       GVFixCoder().encode(q))
    err = (GVRatioCoder().encode(q.to(dev)).cpu() - GVRatioCoder().encode(q))
    assert (err.abs() <= ratio_bound(q)).all()
