"""The other backbones (ConvNeXt, LSKNet, Res2Net, SK2Res2Net, Swin) on a
CUDA GPU against the CPU (``python -m pytest -m cuda --noconftest
tests/test_torch_other_backbones_cuda.py`` on the card; every test here
skips without one): each tiny backbone's training forward, backward and
eval forward, the tiny LSKNet Oriented R-CNN's and ConvNeXt
RoI-Transformer's ``predict`` and loss, K2 at LSKNet's MLP widths and K6
at ConvNeXt's (k, d) = (7, 1), each against its plain version. Also the
torch-only pieces the CPU tests and ``chip_smoke.py`` share: the tiny
configurations and the comparisons."""

import pytest
import torch

from rs_detection_tpu_torch.models.networks import \
    roi_transformer  # noqa: F401  (registers the networks)
from rs_detection_tpu_torch.utils import registry as reg

pytestmark = pytest.mark.cuda

# (config, input side) of each tiny backbone: narrow widths, and for Swin
# a side whose stages (18, 9, 5, 3 at window 7) pad, shift, merge an odd
# map and meet a window smaller than 7
TINY_BACKBONES = {
    "convnext": (dict(type="ConvNeXt", depths=(1, 1, 2, 1),
                      dims=(16, 32, 48, 64)), 64),
    "lsknet": (dict(type="LSKNet", embed_dims=(16, 32, 48, 64),
                    depths=(1, 1, 2, 1)), 64),
    "res2net": (dict(type="Res2Net", depth=50, base_width=8,
                     norm_eval=False), 64),
    "sk2res2net": (dict(type="SK2Res2Net", depth=50, base_width=8,
                        cardinality=2, norm_eval=False), 64),
    "swin": (dict(type="Swin", embed_dim=16, depths=(2, 2, 2, 2),
                  num_heads=(2, 2, 4, 4), drop_path_rate=0.0), 72),
}
# on the card the Res2Nets run with their default ``norm_eval``: their
# train-mode norms over a 2 x 2 map of 2 samples (stage 4 of a 64^2 input)
# are ill-conditioned in f32 (CUDA and the CPU differ by 5e-4 to 2e-3 of
# the last output); the CPU tests hold that path to JAX in f64
CARD_OVERRIDES = {"res2net": dict(norm_eval=True),
                  "sk2res2net": dict(norm_eval=True)}
TINY_DIMS = [16, 32, 40, 64]
# CUDA against the CPU, f32, relative to each tensor's largest value (a
# gradient's at least 1e-3 of the largest gradient)
OUT_TOL, GRAD_TOL = 1e-4, 1e-3


def tiny_lsknet_orcnn():
    """The tiny flagship (``flagship_cfg(tiny=True)``) on a narrow
    LSKNet, its head sampling 32 rois an image (its 64 proposals and the
    ground truths are fewer than the flagship's 512 slots, which the JAX
    head's ``top_k`` cannot fill)."""
    from rs_detection_tpu_torch.flagship import flagship_cfg

    cfg = flagship_cfg(tiny=True)
    cfg["backbone"] = dict(type="LSKNet", embed_dims=TINY_DIMS,
                           depths=[1, 1, 2, 1])
    cfg["bbox_head"]["sampler"] = dict(cfg["bbox_head"]["sampler"], num=32)
    return cfg


def tiny_convnext_roitrans():
    """The tiny RoI-Transformer of ``test_torch_roitrans_cuda.py`` on a
    narrow ConvNeXt."""
    from test_torch_roitrans_cuda import tiny_model

    cfg = tiny_model("roitrans")
    cfg["backbone"] = dict(type="ConvNeXt", depths=[1, 1, 2, 1],
                           dims=TINY_DIMS)
    cfg["neck"]["in_channels"] = list(TINY_DIMS)
    return cfg


TINY_NETWORKS = {"lsknet_orcnn": tiny_lsknet_orcnn,
                 "convnext_roitrans": tiny_convnext_roitrans}


def seeded(model, seed):
    """``init_weights`` from ``seed``, and the layer scales (ConvNeXt's
    ``gamma`` at 1e-6, LSKNet's at 1e-2) drawn from U(0.2, 0.6), so that
    every block moves the output."""
    from rs_detection_tpu_torch.flagship import init_weights

    g = torch.Generator().manual_seed(seed)
    init_weights(model, g)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith(("gamma", "layer_scale_1", "layer_scale_2")):
                p.uniform_(0.2, 0.6, generator=g)
    return model


def rel_errors(got, ref):
    """{name: max |got - ref| / scale} over dicts of tensors; the scale is
    each tensor's largest value, for a gradient at least 1e-3 of the
    largest gradient."""
    gmax = max((r.abs().max().item() for k, r in ref.items()
                if k.startswith("grad")), default=0.0)
    out = {}
    for k, r in ref.items():
        scale = max(r.abs().max().item(),
                    1e-3 * gmax if k.startswith("grad") else 1e-30)
        out[k] = (got[k].cpu().double() - r.double()).abs().max().item() \
            / scale
    return out


def backbone_run(name, device, seed=51):
    """One tiny backbone from ``seed`` on ``device``: its training
    outputs, every parameter's gradient of a seeded projection of them,
    then its eval outputs (after the training forward moved the running
    statistics), as {name: tensor}; ``CARD_OVERRIDES`` applied."""
    cfg, side = TINY_BACKBONES[name]
    model = seeded(reg.build_from_cfg(
        dict(cfg, **CARD_OVERRIDES.get(name, {})), reg.BACKBONES), seed)
    model.to(device).train()
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(2, side, side, 3, generator=g)
    outs = model(x.to(device))
    proj = [torch.randn(o.shape, generator=g).to(device) for o in outs]
    sum((o * p).sum() for o, p in zip(outs, proj)).backward()
    res = {f"train output {i}": o.detach() for i, o in enumerate(outs)}
    res.update({f"grad {n}": p.grad for n, p in model.named_parameters()})
    with torch.no_grad():
        res.update({f"eval output {i}": o for i, o in
                    enumerate(model.eval()(x.to(device)))})
    return res


def network_run(kind, device, tiles, targets, seed=52):
    """A tiny network from ``seed`` on ``device``: its ``predict`` of
    ``tiles`` and its training losses (samplers as the caller set
    them)."""
    from rs_detection_tpu_torch.flagship import normalize

    model = seeded(reg.build_from_cfg(TINY_NETWORKS[kind](), reg.MODELS),
                   seed).to(device)
    x = normalize(tiles.to(device))
    with torch.no_grad():
        pred = model.eval().predict(x)
        losses = model.train().loss(
            x, {k: v.to(device) for k, v in targets.items()},
            torch.Generator(device=device).manual_seed(0))
    return pred, {k: float(v) for k, v in losses.items()}


def mlp_case(c, ch, h, dtype, device, seed=53, n=1):
    """Seeded VAN MLP operands (``van_mlp``'s argument order)."""
    g = torch.Generator().manual_seed(seed)

    def r(*s, scale=1.0):
        return (scale * torch.randn(*s, generator=g)).to(device, dtype)

    return (r(n, h, h, c), r(ch, c, scale=c ** -0.5), r(ch, scale=0.1),
            r(ch, 9, scale=1 / 3), r(ch, scale=0.1),
            r(c, ch, scale=ch ** -0.5), r(c, scale=0.1))


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", sorted(TINY_BACKBONES))
def test_tiny_backbone_cuda_matches_cpu(dev, name):
    """Training outputs and eval outputs within 1e-4, gradients within
    1e-3 (f32; cuDNN and the CPU sum in other orders, through LSKNet's
    train-mode norms over 2 samples)."""
    ref = backbone_run(name, "cpu")
    errs = rel_errors(backbone_run(name, dev), ref)
    for k, e in errs.items():
        assert e <= (GRAD_TOL if k.startswith("grad") else OUT_TOL), (k, e)


@pytest.mark.parametrize("kind", sorted(TINY_NETWORKS))
def test_tiny_network_cuda_matches_cpu(dev, kind, monkeypatch):
    """``predict``: the same valid proposals, polys within 1e-2 px,
    scores within 1e-5; losses within 1e-4 relative (first-k sampling)."""
    from test_torch_roitrans_cuda import first_k_sample, tiny_inputs

    from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler

    monkeypatch.setattr(RandomSampler, "sample", first_k_sample)
    tiles, targets = tiny_inputs()
    p_cpu, l_cpu = network_run(kind, "cpu", tiles, targets)
    p_gpu, l_gpu = network_run(kind, dev, tiles, targets)
    assert torch.equal(p_cpu["valid"], p_gpu["valid"].cpu())
    assert (p_gpu["polys"].cpu() - p_cpu["polys"]).abs().max() <= 1e-2
    assert (p_gpu["scores"].cpu() - p_cpu["scores"]).abs().max() <= 1e-5
    for k, v in l_cpu.items():
        assert abs(l_gpu[k] - v) <= 1e-4 * max(abs(v), 1e-6), (k, l_gpu[k], v)


@pytest.mark.parametrize("stride", [1, 2])
def test_padded_avg_pool_gradient_matches_cpu(dev, stride):
    """``res2net.padded_avg_pool`` on a channels_last CUDA tensor (a
    channel split of one, as Res2Net pools it) has the CPU's output and
    input gradient; ``F.avg_pool2d`` there in channels_last does not
    (torch 2.11), which is why it copies to NCHW."""
    import torch.nn.functional as F

    from rs_detection_tpu_torch.models.backbones.res2net import \
        padded_avg_pool

    def run(device, fn):
        g = torch.Generator().manual_seed(stride)
        x = torch.randn(2, 32, 8, 8, generator=g).contiguous(
            memory_format=torch.channels_last).to(device).requires_grad_()
        y = fn(torch.split(x, 8, dim=1)[-1])
        (y * torch.randn(y.shape, generator=g).to(device)).sum().backward()
        return y.detach().cpu(), x.grad.cpu()

    y_cpu, g_cpu = run("cpu", lambda t: F.avg_pool2d(t, 3, stride, 1))
    y_gpu, g_gpu = run(dev, lambda t: padded_avg_pool(t, stride))
    assert (y_gpu - y_cpu).abs().max() <= 1e-6
    assert (g_gpu - g_cpu).abs().max() <= 1e-6


@pytest.mark.parametrize("c,ch,h", [(64, 512, 64), (128, 1024, 32),
                                    (320, 1280, 16), (512, 2048, 8)])
def test_k2_at_lsknet_mlp_widths(dev, c, ch, h):
    """K2 against its plain version at LSKNet-S's four MLP widths, bf16
    (a 256^2 tile's maps), within 2e-2 of the largest value."""
    from rs_detection_tpu_torch.ops import van_mlp as vm

    args = mlp_case(c, ch, h, torch.bfloat16, dev)
    got = vm.van_mlp_cuda(*args).float()
    ref = vm.van_mlp_reference(*args).float()
    assert (got - ref).abs().max() <= 2e-2 * ref.abs().max()


@pytest.mark.parametrize("c,h", [(256, 32), (512, 16), (1024, 8),
                                 (2048, 4)])
def test_k6_at_convnext_widths(dev, c, h):
    """K6 at (k, d) = (7, 1) (its first design) against the tap loop at
    ConvNeXt-XL's four widths, f32 NCHW as ``ConvNeXtBlock`` hands it
    over, within 1e-4 of the largest value."""
    from rs_detection_tpu_torch.ops import dw_conv as dwc

    g = torch.Generator(device=dev).manual_seed(c)
    x = torch.randn(2, c, h, h, generator=g, device=dev)
    gr = torch.randn(2, c, h, h, generator=g, device=dev)
    got = dwc.dw_wgrad_cuda(x, gr, 7, 1)
    ref = dwc.dw_wgrad_reference(x, gr, 7, 1)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert dwc.wgrad_plan(x.shape, x.stride(), gr.stride(), 7, 1,
                          4)["design"] == "generic"
