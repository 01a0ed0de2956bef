"""RetinaNet on a CUDA GPU against the CPU (``python -m pytest -m cuda
--noconftest tests/test_torch_retinanet_cuda.py`` on the card; every test
here skips without one): the tiny network in both head forms,
``predict`` and three ``GradMutilpySGD`` steps with the
``YangXuePrameterGroupsGenerator`` links. Also the torch-only pieces the
CPU tests and ``chip_smoke.py`` share: the tiny network as a config
section, its run and its inputs."""

import pytest
import torch

from rs_detection_tpu_torch.models.networks import \
    single_stage  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda

# the card against the CPU, f32: tiny predict (phase 5's), the steps'
# losses (phase 9's); parameters after 3 clipped SGD steps at rate <= 0.01
POLY_ATOL, SCORE_ATOL, LOSS_RTOL, PARAM_ATOL = 1e-2, 1e-5, 1e-4, 1e-5
FORMS = ("modern", "legacy")
STEM = ("backbone.Conv_0.weight", "backbone.Norm_0.weight",
        "backbone.Norm_0.bias")


def tiny_model(form):
    """A tiny RetinaNet: ResNet-18 with running statistics, a 32-wide FPN
    from C3 with ``on_output`` extra convs after a ReLU, and the head
    ("modern": ``retinanet_r50_fpn_1x_dota.py``'s ``bbox_head`` at 32
    channels, 3 classes, 9 anchors a position; "legacy":
    ``retinanet_r50v1d_fpn_dota.py``'s ``rpn_net`` at 32 channels, 2
    classes, 2 angles, 18 anchors a position, 64 detection slots)."""
    m = dict(type="RetinaNet",
             backbone=dict(type="ResNet", depth=18, norm_eval=True),
             neck=dict(type="FPN", in_channels=[64, 128, 256, 512],
                       out_channels=32, start_level=1, num_outs=5,
                       add_extra_convs="on_output",
                       relu_before_extra_convs=True))
    if form == "legacy":
        m["rpn_net"] = dict(
            type="RetinaHead", n_class=2, mode="R", in_channels=32,
            stacked_convs=2, max_dets=64, nms_iou_threshold=0.3,
            roi_beta=1 / 9, score_threshold=0.05, loc_loss_weight=0.2,
            anchor_generator=dict(
                type="AnchorGeneratorRotated", angles=[-90, -45],
                base_sizes=[32, 64, 128, 256, 512], mode="H",
                ratios=[1, 0.5, 2.0],
                scales=[1, 1.2599210498948732, 1.5874010519681994],
                strides=[8, 16, 32, 64, 128]))
    else:
        m["bbox_head"] = dict(type="RetinaHead", num_classes=3,
                              in_channels=32, feat_channels=32,
                              stacked_convs=2, nms_pre=256, max_per_img=64)
    return m


def tiny_inputs(seed=41):
    """Two seeded 128^2 tiles and 6 axis-aligned boxes each (as
    ``chip_smoke.py``'s phase 9: the low-quality rescue keeps every
    anchor that ties a box's best IoU, and the devices' sines differ in
    the last bit), labels 1-2."""
    from rs_detection_tpu_torch.flagship import make_targets

    g = torch.Generator().manual_seed(seed)
    tiles = torch.randint(0, 256, (2, 128, 128, 3), generator=g,
                          dtype=torch.uint8)
    targets = make_targets(2, 128, 6, g)
    targets["rboxes"][..., 4] = 0.0
    targets["labels"] = targets["labels"].clamp(max=2)
    return tiles, targets


def run_tiny(form, device, tiles, targets, steps=3):
    """The tiny model from seed 3 on ``device``: its ``predict`` of
    ``tiles`` with ``retina_cls`` spread (weights x 60, bias 0, so that
    the random head detects), then, from the model as drawn, ``steps``
    steps of ``GradMutilpySGD`` (clip at 0.5, so that it scales) with the
    recipe's YangXue links (conv biases x 2 and decay 0, the stem
    frozen). Returns (model, predict, per-step losses)."""
    from rs_detection_tpu_torch.flagship import init_weights, normalize
    from rs_detection_tpu_torch.models.param_generators import \
        YangXuePrameterGroupsGenerator
    from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
    from rs_detection_tpu_torch.optims.optimizer import GradMutilpySGD
    from rs_detection_tpu_torch.parallel.train_step import train_step

    model = reg.build_from_cfg(tiny_model(form), reg.MODELS)
    init_weights(model, torch.Generator().manual_seed(3))
    model.to(device)
    head = model.bbox_head
    drawn = {k: v.clone() for k, v in head.state_dict().items()}
    with torch.no_grad():
        head.retina_cls.weight.mul_(60.0)
        head.retina_cls.bias.zero_()
    pred = model.eval().predict(normalize(tiles.to(device)))
    head.load_state_dict(drawn)
    opt = GradMutilpySGD(model.named_parameters(), lr=0.01, momentum=0.9,
                         weight_decay=1e-4, grad_clip=dict(max_norm=0.5))
    YangXuePrameterGroupsGenerator(
        conv_bias_grad_muyilpy=2.0, conv_bias_weight_decay=0.0,
        freeze_prefix=["backbone.C1"])(opt, base_weight_decay=1e-4)
    sched = StepLR([8], warmup="linear", warmup_iters=4, warmup_ratio=0.25)
    losses = []
    for _ in range(steps):
        out = train_step(model, opt, sched, normalize(tiles.to(device)),
                         {k: v.to(device) for k, v in targets.items()},
                         None, epoch=opt.iterations / 2)
        losses.append({k: float(v) for k, v in out.items()})
    return model, pred, losses


def compare(cpu, gpu):
    """Worst differences of two ``run_tiny`` results: polys, scores,
    losses (relative) and parameters."""
    (m_c, p_c, l_c), (m_g, p_g, l_g) = cpu, gpu
    sd_c, sd_g = m_c.state_dict(), m_g.state_dict()
    return dict(
        polys=(p_g["polys"].cpu() - p_c["polys"]).abs().max().item(),
        scores=(p_g["scores"].cpu() - p_c["scores"]).abs().max().item(),
        losses=max(abs(g[k] - c[k]) / max(abs(c[k]), 1e-6)
                   for g, c in zip(l_g, l_c) for k in c),
        params=max((sd_g[k].cpu().float() - v.float()).abs().max().item()
                   for k, v in sd_c.items()
                   if not k.endswith("num_batches_tracked")))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("form", FORMS)
def test_tiny_retinanet_cuda_matches_cpu(dev, form):
    """The same detection slots and labels, polygons within 1e-2 px,
    scores within 1e-5, the losses of three steps within 1e-4 relative,
    every parameter within 1e-5, the frozen stem unmoved on the card."""
    from rs_detection_tpu_torch.flagship import init_weights

    tiles, targets = tiny_inputs()
    cpu = run_tiny(form, "cpu", tiles, targets)
    gpu = run_tiny(form, dev, tiles, targets)
    assert torch.equal(cpu[1]["valid"], gpu[1]["valid"].cpu())
    assert torch.equal(cpu[1]["labels"], gpu[1]["labels"].cpu())
    err = compare(cpu, gpu)
    assert err["polys"] <= POLY_ATOL and err["scores"] <= SCORE_ATOL
    assert err["losses"] <= LOSS_RTOL and err["params"] <= PARAM_ATOL
    fresh = reg.build_from_cfg(tiny_model(form), reg.MODELS)
    init_weights(fresh, torch.Generator().manual_seed(3))
    for k in STEM:
        assert torch.equal(gpu[0].state_dict()[k].cpu(),
                           fresh.state_dict()[k])
