"""The port's CUDA kernels against their plain PyTorch versions, on a
CUDA GPU: ``python -m pytest -m cuda --noconftest
tests/test_torch_port_cuda.py`` (``--noconftest`` where jax is not
installed: ``tests/conftest.py`` imports it). Without a GPU every test
here skips; ``chip_smoke.py`` runs the same checks at the flagship
shapes. Covers K1 and K2 (serving), K3 and K6 (training), K4, K2r, K5
and K7's layout (fused serving), K2q with its residual form and the
integer products of the int8 serving mode, what the redesigned K2 / K2r,
K2q, K4 and K6 make fragile (ragged tiles and pixel counts, every bf16
width, partial hidden chunks, every kernel size and dilation in both
memory formats, launch plans mirrored in Python, K2q's weight
preparation against ``qweight``; K3's gather design bit for bit across
launches and on clustered rois, K5's streaming design at ragged shapes
with and without bias; K1's row design and the row-streaming design of
K7's form at ragged shapes, beside their first designs), the rule that a kernel
wrapper never hands autograd a detached result, the tiny config's
predict (fused and not, int8 and not) and training step, and its test
task through ``Runner``, CUDA against CPU."""

import os

import pytest
import torch

from rs_detection_tpu_torch.flagship import (build_flagship, flagship_cfg,
                                             make_targets, normalize)
from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
from rs_detection_tpu_torch.ops import dw_conv, van_mlp
from rs_detection_tpu_torch.ops._build import kernel_library
from rs_detection_tpu_torch.ops.dw_conv import (dw_wgrad_cuda,
                                                dw_wgrad_reference,
                                                launcher_plan, wgrad_plan)
from rs_detection_tpu_torch.ops.roi_align import (
    k3_vec, roi_align_rotated_pyramid, roi_align_rotated_pyramid_bwd_cuda,
    roi_align_rotated_pyramid_bwd_first_design,
    roi_align_rotated_pyramid_bwd_reference,
    roi_align_rotated_pyramid_bwd_sorted_reference,
    roi_align_rotated_pyramid_cuda, roi_align_rotated_pyramid_reference)
from rs_detection_tpu_torch.ops import roi_align as _roi_align
from rs_detection_tpu_torch.ops import dwconv as _dwconv
from rs_detection_tpu_torch.ops.dwconv import (
    depthwise_conv2d, depthwise_conv2d_cuda, depthwise_conv2d_first_design,
    depthwise_conv2d_reference, dw_chw_cuda, dw_chw_reference, dw_plan)
from rs_detection_tpu_torch.ops.van_attn import (attn_plan, van_attn_cuda,
                                                 van_attn_reference)
from rs_detection_tpu_torch.ops import quant
from rs_detection_tpu_torch.ops.van_mlp import (
    kernel_plan, van_mlp_cuda, van_mlp_int8, van_mlp_int8_cuda, van_mlp_int8_reference,
    van_mlp_reference, van_mlp_residual_cuda, van_mlp_residual_int8_cuda,
    van_mlp_residual_int8_reference, van_mlp_residual_reference)
from rs_detection_tpu_torch.optims.lr_scheduler import StepLR
from rs_detection_tpu_torch.optims.optimizer import AdamW
from rs_detection_tpu_torch.parallel.train_step import train_step

pytestmark = pytest.mark.cuda

# max|kernel - plain| / max|plain|: bf16 rounds the hidden tensor at
# other points in the two versions (1-2 ulps of 2^-8); f32 differs only
# in summation order
REL_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _assert_close(got, ref, dtype):
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= REL_TOL[dtype] * ref.float().abs().max().item(), err


@pytest.mark.parametrize("shape,dtype", [
    ((2, 9, 11, 32, 64), torch.float32),
    ((2, 13, 17, 64, 512), torch.bfloat16),
    ((1, 16, 16, 320, 1280), torch.bfloat16),
    ((1, 8, 8, 512, 2048), torch.bfloat16)])
def test_van_mlp_kernel_matches_plain(dev, shape, dtype):
    n, h, w, c, ch = shape
    g = torch.Generator(device=dev).manual_seed(0)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    args = (r(n, h, w, c), r(ch, c, scale=c ** -0.5), r(ch, scale=0.1),
            r(ch, 9, scale=1 / 3), r(ch, scale=0.1),
            r(c, ch, scale=ch ** -0.5), r(c, scale=0.1))
    before = van_mlp_cuda.launches
    got = van_mlp_cuda(*args)
    torch.cuda.synchronize()
    assert van_mlp_cuda.launches == before + 1
    _assert_close(got, van_mlp_reference(*args), dtype)


def _pyramid(dev, dtype, c, seed, r=600):
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = [torch.randn(2, s, s, c, generator=g, device=dev).to(dtype)
             for s in (64, 32, 16, 8)]

    def u(lo, hi):
        return torch.rand(r, generator=g, device=dev) * (hi - lo) + lo

    scale, aspect = torch.exp(u(2.0, 6.8)), torch.exp(u(-1.5, 1.5))
    rois = torch.stack([torch.randint(0, 2, (r,), generator=g,
                                      device=dev).float(),
                        u(-50, 300), u(-50, 300), scale * aspect,
                        scale / aspect, u(-3.2, 3.2)], 1)
    return feats, rois


@pytest.mark.parametrize("dtype,c", [(torch.float32, 16),
                                     (torch.float32, 30),
                                     (torch.bfloat16, 256)])
def test_roi_align_kernel_matches_plain(dev, dtype, c):
    feats, rois = _pyramid(dev, dtype, c, seed=1)
    got = roi_align_rotated_pyramid_cuda(feats, rois)
    torch.cuda.synchronize()
    _assert_close(got, roi_align_rotated_pyramid_reference(feats, rois),
                  dtype)


def test_tiny_predict_cuda_matches_cpu(dev):
    tiles = torch.randint(0, 256, (2, 128, 128, 3),
                          generator=torch.Generator().manual_seed(2),
                          dtype=torch.uint8)
    cpu = build_flagship(tiny=True, device="cpu").predict(normalize(tiles))
    gpu = build_flagship(tiny=True, device=dev).predict(
        normalize(tiles.to(dev)))
    assert torch.equal(gpu["valid"].cpu(), cpu["valid"])
    torch.testing.assert_close(gpu["scores"].cpu(), cpu["scores"],
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(gpu["polys"].cpu(), cpu["polys"],
                               rtol=0, atol=1e-2)


def test_kernel_wrappers_refuse_inputs_that_require_grad(dev):
    """Autograd does not see a ctypes launch: a wrapper given an input
    that requires a gradient must raise, never return a detached output
    (the VAN MLP trains through its plain version, the RoIAlign through
    its autograd function, whose backward is K3)."""
    x = torch.randn(1, 4, 4, 32, device=dev)
    mlp = [x, torch.randn(64, 32, device=dev), torch.zeros(64, device=dev),
           torch.randn(64, 9, device=dev), torch.zeros(64, device=dev),
           torch.randn(32, 64, device=dev), torch.zeros(32, device=dev)]
    mlp[1].requires_grad_()
    with pytest.raises(RuntimeError, match="requires a gradient"):
        van_mlp_cuda(*mlp)
    feats, rois = _pyramid(dev, torch.float32, 16, seed=5, r=20)
    feats[0].requires_grad_()
    with pytest.raises(RuntimeError, match="requires a gradient"):
        roi_align_rotated_pyramid_cuda(feats, rois)
    out = roi_align_rotated_pyramid(feats, rois)
    assert out.grad_fn is not None
    with torch.no_grad():
        assert van_mlp_cuda(*mlp).grad_fn is None


@pytest.mark.parametrize("dtype,c,tol", [(torch.float32, 16, 1e-5),
                                         (torch.float32, 30, 1e-5),
                                         (torch.bfloat16, 256, 1e-2)])
def test_roi_align_backward_kernel_matches_plain(dev, dtype, c, tol):
    """K3 against autograd of the plain forward (f32 sums, one rounding
    on both sides; atomics reorder the sums), relative to max|plain|."""
    feats, rois = _pyramid(dev, dtype, c, seed=3)
    grad = torch.randn(rois.shape[0], 7, 7, c, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(4)
                       ).to(dtype)
    before = roi_align_rotated_pyramid_bwd_cuda.launches
    got = roi_align_rotated_pyramid_bwd_cuda(feats, rois, grad)
    torch.cuda.synchronize()
    assert roi_align_rotated_pyramid_bwd_cuda.launches == before + 1
    ref = roi_align_rotated_pyramid_bwd_reference(feats, rois, grad)
    scale = max(r.float().abs().max().item() for r in ref)
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


def test_roi_align_kernels_are_adjoint(dev):
    """<K1(f), g> == <f, K3(g)> in f32, to 1e-5 relative."""
    feats, rois = _pyramid(dev, torch.float32, 32, seed=6)
    grad = torch.randn(rois.shape[0], 7, 7, 32, device=dev)
    lhs = (roi_align_rotated_pyramid_cuda(feats, rois).double()
           * grad.double()).sum()
    rhs = sum((f.double() * d.double()).sum() for f, d in zip(
        feats, roi_align_rotated_pyramid_bwd_cuda(feats, rois, grad)))
    assert abs(lhs - rhs).item() <= 1e-5 * abs(lhs).item()


@pytest.mark.parametrize("k,d", [(3, 1), (5, 1), (7, 3)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-3)])
@pytest.mark.parametrize("channels_last", [False, True])
def test_dw_wgrad_kernel_matches_plain(dev, k, d, dtype, tol, channels_last):
    """K6 against the tap loop, odd sizes and a ragged channel tile;
    max|diff| / max|plain| (f32 sums in another order)."""
    g = torch.Generator(device=dev).manual_seed(7)
    shape = (2, 40, 37, 45)
    x = torch.randn(*shape, generator=g, device=dev).to(dtype)
    gr = torch.randn(*shape, generator=g, device=dev).to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    before = dw_wgrad_cuda.launches
    got = dw_wgrad_cuda(x, gr, k, d)
    torch.cuda.synchronize()
    assert dw_wgrad_cuda.launches == before + 1
    ref = dw_wgrad_reference(x, gr, k, d)
    assert got.shape == (k * k, 40) and got.dtype == torch.float32
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_tiny_train_step_cuda_matches_cpu(dev):
    """One training step of the tiny config: CUDA (K1, K3, K6) against
    the CPU (plain versions), f32 with TF32 off, samplers that take every
    candidate. Losses to 1e-4 relative, gradients to 1e-3 of each
    parameter's largest (the biases ahead of a BatchNorm have none)."""
    rng = torch.Generator().manual_seed(3)
    images = torch.randn(2, 64, 64, 3, generator=rng)
    targets = make_targets(2, 64, 6, rng)
    # axis-aligned: CPU and CUDA sin/cos differ in the last ulp, which
    # can break the exact IoU ties that the RPN's low-quality rescue
    # keeps, and so change the sampled set
    targets["rboxes"][..., 4] = 0.0
    runs = []
    for device in ("cpu", dev):
        model = build_flagship(tiny=True, device=device, train=True)
        model.rpn.sampler = RandomSampler(num=4096, pos_fraction=1.0)
        model.bbox_head.sampler = RandomSampler(num=70, pos_fraction=1.0)
        before = dw_wgrad_cuda.launches
        losses = train_step(model, AdamW(model.parameters()), StepLR([7]),
                            images.to(device),
                            {k: v.to(device) for k, v in targets.items()},
                            torch.Generator(device=device).manual_seed(0))
        runs.append((losses, {k: p.grad.cpu() for k, p in
                              model.named_parameters()}))
    assert dw_wgrad_cuda.launches == before + 15      # 5 blocks x 3 convs
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs
    for k, v in l_cpu.items():
        assert abs(l_gpu[k].item() - v.item()) <= 1e-4 * abs(v.item()), k
    for k, a in g_cpu.items():
        if k.startswith("backbone.patch_embed") and k.endswith("proj.bias"):
            continue
        scale = max(a.abs().max().item(), g_gpu[k].abs().max().item(), 1e-12)
        assert (g_gpu[k] - a).abs().max().item() <= 1e-3 * scale, k


def _mlp_args(dev, shape, dtype, seed=0):
    n, h, w, c, ch = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    return (r(n, h, w, c), r(ch, c, scale=c ** -0.5), r(ch, scale=0.1),
            r(ch, 9, scale=1 / 3), r(ch, scale=0.1),
            r(c, ch, scale=ch ** -0.5), r(c, scale=0.1))


@pytest.mark.parametrize("shape,dtype", [
    ((2, 9, 11, 32, 64), torch.float32),
    ((2, 13, 17, 64, 512), torch.bfloat16),
    ((1, 8, 8, 512, 2048), torch.bfloat16)])
def test_van_mlp_residual_kernel_matches_plain(dev, shape, dtype):
    """K2r: the kernel's residual flag, against ``x + mlp(x)`` summed in
    f32; its launches count apart from K2's."""
    args = _mlp_args(dev, shape, dtype, seed=8)
    before, before_k2 = van_mlp_residual_cuda.launches, van_mlp_cuda.launches
    got = van_mlp_residual_cuda(*args)
    torch.cuda.synchronize()
    assert van_mlp_residual_cuda.launches == before + 1
    assert van_mlp_cuda.launches == before_k2
    _assert_close(got, van_mlp_residual_reference(*args), dtype)


def _attn_args(dev, shape, dtype, seed=9):
    n, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0, dt=dtype):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dt)

    f32, mix = torch.float32, c ** -0.5
    return (r(n, h, w, c, scale=0.5), 1 + r(c, scale=0.1, dt=f32),
            r(c, scale=0.1, dt=f32), r(c, c, 1, 1, scale=mix),
            r(c, scale=0.1), r(c, 1, 5, 5, scale=0.2), r(c, scale=0.1),
            r(c, 1, 7, 7, scale=1 / 7), r(c, scale=0.1),
            r(c, c, 1, 1, scale=mix), r(c, scale=0.1),
            r(c, c, 1, 1, scale=mix), r(c, scale=0.1), r(c, scale=0.3))


@pytest.mark.parametrize("shape,dtype", [
    ((1, 13, 16, 32), torch.float32),      # H no multiple of any tile
    ((2, 24, 20, 32), torch.float32),
    ((2, 9, 7, 40), torch.float32),        # C no multiple of 32
    ((2, 30, 41, 64), torch.bfloat16),
    ((1, 16, 16, 320), torch.bfloat16),
    ((1, 8, 8, 512), torch.bfloat16)])
def test_van_attn_kernel_matches_plain(dev, shape, dtype):
    """K4 against bn1 affine + ``sa_core`` + layer scale + residual. bf16
    rounds at fewer points in the kernel than in the plain chain."""
    args = _attn_args(dev, shape, dtype)
    before = van_attn_cuda.launches
    before_dw = depthwise_conv2d_cuda.launches
    got = van_attn_cuda(*args)
    torch.cuda.synchronize()
    assert van_attn_cuda.launches == before + 1
    assert depthwise_conv2d_cuda.launches == before_dw + 2  # dw5, dw7d3
    _assert_close(got, van_attn_reference(*args), dtype)


@pytest.mark.parametrize("k,d", [(3, 1), (5, 1), (7, 3)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_depthwise_conv2d_kernel_matches_plain(dev, k, d, dtype, tol):
    """K5 and its ``[N, H, C, W]`` form against ``F.conv2d``: odd sizes,
    a ragged channel tile, f32 tap sums and one rounding on both sides
    (one bf16 ulp of the largest value)."""
    g = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn(2, 37, 45, 40, generator=g, device=dev).to(dtype)
    w = (torch.randn(k, k, 40, generator=g, device=dev) / k).to(dtype)
    before = depthwise_conv2d_cuda.launches
    got = depthwise_conv2d_cuda(x, w, k, d)
    torch.cuda.synchronize()
    assert depthwise_conv2d_cuda.launches == before + 1
    ref = depthwise_conv2d_reference(x, w, k, d)
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= tol * scale
    xc = x.permute(0, 1, 3, 2).contiguous()
    wc = w.reshape(k * k, 40).t().contiguous()
    before = dw_chw_cuda.launches
    got = dw_chw_cuda(xc, wc, k, d)
    torch.cuda.synchronize()
    assert dw_chw_cuda.launches == before + 1
    ref = dw_chw_reference(xc, wc, k, d)
    assert (got.float() - ref.float()).abs().max().item() <= tol * scale


def test_depthwise_conv2d_gradients_match_plain(dev):
    """``dx`` (K5 on the flipped taps) and ``dw`` (K6) against autograd
    of the plain version, f32."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(2, 21, 19, 40, generator=g, device=dev)
    w = torch.randn(7, 7, 40, generator=g, device=dev) / 7
    gr = torch.randn(2, 21, 19, 40, generator=g, device=dev)
    grads = []
    for fn in (depthwise_conv2d, depthwise_conv2d_reference):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        grads.append(torch.autograd.grad(fn(xg, wg, 7, 3), (xg, wg), gr))
    for got, ref, tol in zip(grads[0], grads[1], (1e-5, 1e-4)):
        assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


def test_fused_wrappers_refuse_inputs_that_require_grad(dev):
    attn = list(_attn_args(dev, (1, 6, 6, 32), torch.float32))
    attn[3].requires_grad_()
    with pytest.raises(RuntimeError, match="requires a gradient"):
        van_attn_cuda(*attn)
    mlp = list(_mlp_args(dev, (1, 4, 4, 32, 64), torch.float32))
    mlp[5].requires_grad_()
    with pytest.raises(RuntimeError, match="requires a gradient"):
        van_mlp_residual_cuda(*mlp)
    x = torch.randn(1, 6, 6, 32, device=dev, requires_grad=True)
    w = torch.randn(5, 5, 32, device=dev)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        depthwise_conv2d_cuda(x, w, 5, 1)
    with pytest.raises(RuntimeError, match="requires a gradient"):
        dw_chw_cuda(x, torch.randn(6, 25, device=dev), 5, 1)
    assert depthwise_conv2d(x, w, 5, 1).grad_fn is not None
    with torch.no_grad():
        assert van_attn_cuda(*attn).grad_fn is None
        assert van_mlp_residual_cuda(*mlp).grad_fn is None


def test_tiny_fused_predict_cuda_matches_cpu(dev):
    """The fused serving mode of the tiny config: CUDA (K4, K2r, K5, K1)
    against the CPU (plain versions), and against the non-fused mode on
    CUDA; f32 with TF32 off."""
    tiles = torch.randint(0, 256, (2, 128, 128, 3),
                          generator=torch.Generator().manual_seed(2),
                          dtype=torch.uint8)
    cpu = build_flagship(tiny=True, device="cpu", fused=True).predict(
        normalize(tiles))
    before = van_attn_cuda.launches, van_mlp_residual_cuda.launches
    gpu = build_flagship(tiny=True, device=dev, fused=True).predict(
        normalize(tiles.to(dev)))
    assert van_attn_cuda.launches == before[0] + 5          # 5 blocks
    assert van_mlp_residual_cuda.launches == before[1] + 5
    plain = build_flagship(tiny=True, device=dev).predict(
        normalize(tiles.to(dev)))
    for ref in (cpu, plain):
        assert torch.equal(gpu["valid"].cpu(), ref["valid"].cpu())
        torch.testing.assert_close(gpu["scores"].cpu(), ref["scores"].cpu(),
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(gpu["polys"].cpu(), ref["polys"].cpu(),
                                   rtol=0, atol=1e-2)


# K2q against its plain version (the kernel's tile group): the s32 sums are
# exact and the dequantization bit-equal; f32 noise in the depthwise sum and
# the erf (~1e-7) lands a value next to a rounding boundary one int8 step
# apart, which moves an output by ~1e-3 of the largest (f32) or carries it
# over one bf16 rounding boundary (at most 2^-7 of the largest)
INT8_TOL = {torch.bfloat16: 1e-2, torch.float32: 5e-3}


@pytest.mark.parametrize("residual", [False, True], ids=["mlp", "residual"])
@pytest.mark.parametrize("shape,dtype", [
    ((2, 21, 19, 32, 96), torch.float32),     # border tiles, a ragged chunk
    ((1, 8, 8, 20, 40), torch.float32),       # C no multiple of 16
    ((2, 13, 17, 64, 512), torch.bfloat16),
    ((1, 16, 16, 320, 1280), torch.bfloat16),
    ((1, 8, 8, 512, 2048), torch.bfloat16)])
def test_van_mlp_int8_kernel_matches_plain(dev, shape, dtype, residual):
    """K2q and its residual form: within INT8_TOL of the plain version,
    at most 3% of the elements off by more than 1e-5 of the largest
    (f32) or 2^-7 of themselves (bf16), and an int8 quantization error
    (0.1-5% of the largest value) away from the float MLP."""
    args = _mlp_args(dev, shape, dtype, seed=12)
    kernel, plain, fp = (
        (van_mlp_residual_int8_cuda, van_mlp_residual_int8_reference,
         van_mlp_residual_reference) if residual else
        (van_mlp_int8_cuda, van_mlp_int8_reference, van_mlp_reference))
    counts = (van_mlp_int8_cuda.launches, van_mlp_residual_int8_cuda.launches,
              van_mlp_cuda.launches, van_mlp_residual_cuda.launches)
    got = kernel(*args)
    torch.cuda.synchronize()
    after = (van_mlp_int8_cuda.launches, van_mlp_residual_int8_cuda.launches,
             van_mlp_cuda.launches, van_mlp_residual_cuda.launches)
    assert [b - a for a, b in zip(counts, after)] == [
        int(not residual), int(residual), 0, 0]
    ref = plain(*args).float()
    diff = (got.float() - ref).abs()
    scale = ref.abs().max().item()
    assert diff.max().item() <= INT8_TOL[dtype] * scale
    unit = 1e-5 * scale if dtype == torch.float32 else ref.abs() * 2 ** -7
    assert (diff > unit).float().mean().item() <= 0.03
    qerr = (got.float() - fp(*args).float()).abs().max().item() \
        / fp(*args).float().abs().max().item()
    assert 1e-3 < qerr < 5e-2


def test_van_mlp_int8_refuses_grad_and_other_groups(dev):
    mlp = list(_mlp_args(dev, (1, 4, 4, 32, 64), torch.float32))
    with pytest.raises(ValueError, match="tile"):
        van_mlp_int8(*mlp, group="tensor")   # the kernel has one group
    mlp[1].requires_grad_()
    for fn in (van_mlp_int8_cuda, van_mlp_residual_int8_cuda):
        with pytest.raises(RuntimeError, match="requires a gradient"):
            fn(*mlp)
        with torch.no_grad():
            assert fn(*mlp).grad_fn is None


@pytest.mark.parametrize("m,k,n", [(8 * 64 * 64, 320, 320), (5, 12, 7),
                                   (16, 40, 24), (2046, 64, 48),
                                   (1800, 32, 96)])
def test_int_matmul_cuda_is_bit_equal_to_cpu(dev, m, k, n):
    """Shapes cuBLASLt's int8 product refuses unpadded among them."""
    g = torch.Generator().manual_seed(13)
    a = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
    ref = quant.int_matmul(a, b)
    assert torch.equal(ref, a.int() @ b.int())
    assert torch.equal(quant.int_matmul(a.to(dev), b.to(dev)).cpu(), ref)
    assert torch.equal(quant.int_matmul(
        a.to(dev), b.t().contiguous().t().to(dev)).cpu(), ref)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_int8_conv_cuda_is_bit_equal_to_cpu(dev, k, stride, pad):
    """The s8 operands, the s32 sums and the dequantized output of
    ``int8_conv`` and ``int8_channel_matmul``: elementwise IEEE f32 and
    exact integer sums on both devices."""
    g = torch.Generator().manual_seed(14)
    x = torch.randn(2, 64, 33, 31, generator=g).to(torch.bfloat16)
    w = (torch.randn(48, 64, k, k, generator=g) / 24).to(torch.bfloat16)
    b = torch.randn(48, generator=g).to(torch.bfloat16)
    xq, sx = quant.qact(x.permute(0, 2, 3, 1))
    xq_d, sx_d = quant.qact(x.to(dev).permute(0, 2, 3, 1))
    wq, sw = quant.qweight(w)
    wq_d, sw_d = quant.qweight(w.to(dev))
    for a, c in ((xq, xq_d), (sx, sx_d), (wq, wq_d), (sw, sw_d)):
        assert torch.equal(a, c.cpu())
    acc = quant.int_conv2d(xq, wq, (stride, stride), (pad, pad))
    assert torch.equal(quant.int_conv2d(xq_d, wq_d, (stride, stride),
                                        (pad, pad)).cpu(), acc)
    got = quant.int8_conv(x.to(dev), w.to(dev), b.to(dev), (stride, stride),
                          (pad, pad))
    assert torch.equal(got.cpu(), quant.int8_conv(x, w, b, (stride, stride),
                                                  (pad, pad)))
    if k == 1:
        nhwc = x.permute(0, 2, 3, 1)
        assert torch.equal(
            quant.int8_channel_matmul(nhwc.to(dev), w.view(48, 64).to(dev),
                                      b.to(dev)).cpu(),
            quant.int8_channel_matmul(nhwc, w.view(48, 64), b))


@pytest.mark.parametrize("fused", [False, True], ids=["non_fused", "fused"])
def test_tiny_int8_predict_cuda_matches_cpu(dev, fused):
    """The tiny config served int8, CUDA (K2q, and K4 when fused) against
    the CPU (plain versions, the kernel's scale groups). An int8 step set
    off by the devices' f32 noise sets off more in the next layer, so
    deep in the model the two runs agree as int8 agrees with float: the
    first block on one input within 4 steps of 1/127 (2% of the elements
    past 1e-5 of the largest), the backbone within 0.05 relative per
    level, and ``predict`` without regard to rank (sorted scores per
    class within 0.05)."""
    tiles = torch.randint(0, 256, (2, 128, 128, 3),
                          generator=torch.Generator().manual_seed(2),
                          dtype=torch.uint8)
    images = normalize(tiles)
    cpu = build_flagship(tiny=True, device="cpu", fused=fused, int8=True)
    gpu = build_flagship(tiny=True, device=dev, fused=fused, int8=True)
    wrapper = van_mlp_residual_int8_cuda if fused else van_mlp_int8_cuda
    with torch.no_grad():
        stem = cpu.backbone.patch_embed1(images.permute(0, 3, 1, 2))
        ref = cpu.backbone.block1_0(stem)
        before = wrapper.launches
        got = gpu.backbone.block1_0(stem.to(dev)).cpu()
        assert wrapper.launches == before + 1
        diff, scale = (got - ref).abs(), ref.abs().max().item()
        assert diff.max().item() <= 4 * scale / 127
        assert (diff > 1e-5 * scale).float().mean().item() <= 0.02
        for q, r in zip(gpu.backbone(images.to(dev)), cpu.backbone(images)):
            assert ((q.cpu() - r).abs().max() / r.abs().max()).item() < 0.05
    before = wrapper.launches
    out_gpu, out_cpu = gpu.predict(images.to(dev)), cpu.predict(images)
    assert wrapper.launches == before + 5                    # 5 blocks
    assert abs(int(out_gpu["valid"].sum()) - int(out_cpu["valid"].sum())) \
        <= out_cpu["valid"].numel() // 50
    assert (out_gpu["scores"].cpu().sort(dim=1).values
            - out_cpu["scores"].sort(dim=1).values).abs().max().item() <= 0.05


def _mlp_args(dev, shape, dtype, seed=0):
    n, h, w, c, ch = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=dev) * scale).to(dtype)

    return (r(n, h, w, c), r(ch, c, scale=c ** -0.5), r(ch, scale=0.1),
            r(ch, 9, scale=1 / 3), r(ch, scale=0.1),
            r(c, ch, scale=ch ** -0.5), r(c, scale=0.1))


@pytest.mark.parametrize("residual", [False, True], ids=["mlp", "residual"])
@pytest.mark.parametrize("shape", [
    # H, W no multiples of the 8x8 tile, at every bf16 width; Ch a whole
    # number of chunks, a partial last chunk, and no multiple of 8 (which
    # keeps the WMMA kernel)
    (2, 21, 19, 32, 96), (2, 21, 19, 64, 96), (2, 21, 19, 128, 256),
    (2, 21, 19, 256, 72), (2, 21, 19, 320, 200), (2, 21, 19, 512, 72),
    (1, 9, 70, 64, 512), (1, 9, 70, 128, 100), (1, 9, 70, 320, 1280),
    (1, 9, 70, 512, 2048),
    # smaller than a tile, one image; batch 8
    (1, 3, 5, 64, 64), (1, 1, 1, 512, 32), (8, 16, 24, 64, 128),
    (8, 8, 8, 256, 64)], ids=str)
def test_van_mlp_bf16_designs_match_plain(dev, shape, residual):
    """K2 and K2r in bf16 over the shapes that pick each design of the
    kernel; y must not depend on what lies past the tile's image part."""
    args = _mlp_args(dev, shape, torch.bfloat16, seed=21)
    kernel, plain = ((van_mlp_residual_cuda, van_mlp_residual_reference)
                     if residual else (van_mlp_cuda, van_mlp_reference))
    got = kernel(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _assert_close(got, plain(*args), torch.bfloat16)
    assert torch.equal(got, kernel(*args))      # same launch, same bits


@pytest.mark.parametrize("c,ch,dtype", [
    (64, 512, torch.bfloat16), (128, 1024, torch.bfloat16),
    (256, 72, torch.bfloat16), (320, 1280, torch.bfloat16),
    (512, 2048, torch.bfloat16), (320, 100, torch.bfloat16),
    (512, 100, torch.bfloat16), (32, 96, torch.bfloat16),
    (20, 40, torch.float32), (320, 64, torch.float32)])
def test_van_mlp_plan_mirrors_the_launcher(dev, c, ch, dtype):
    lib = kernel_library()
    limit = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    plan = kernel_plan(c, ch, dtype, limit)
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert plan["smem"] == lib.rs_van_mlp_smem_bytes(c, ch, code)
    assert plan["scratch"] == lib.rs_van_mlp_scratch_bytes(c, ch, code)


def test_kernel_wrappers_refuse_unsupported_shapes_before_building(
        dev, monkeypatch):
    def no_build():
        raise AssertionError("the kernel library must not be built here")

    monkeypatch.setattr(van_mlp, "kernel_library", no_build)
    monkeypatch.setattr(dw_conv, "kernel_library", no_build)
    args = _mlp_args(dev, (1, 8, 8, 48, 96), torch.bfloat16)
    for fn in (van_mlp_cuda, van_mlp_residual_cuda, van_mlp_int8_cuda):
        with pytest.raises(ValueError):
            fn(*args)                       # no bf16 kernel of width 48
    x = torch.zeros(1, 8, 8, 8, device=dev)
    with pytest.raises(ValueError):
        dw_wgrad_cuda(x, x, 4)
    with pytest.raises(ValueError):
        dw_wgrad_cuda(x, x[:, :, :, :4], 3)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("channels_last", [False, True],
                         ids=["nchw", "nhwc"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-3)])
def test_dw_wgrad_designs_match_plain(dev, k, d, channels_last, dtype, tol):
    """K6 at every kernel size and dilation 1 and 3 (VAN's three pairs
    run the two designs for the model's layouts): C no multiple of the
    channel tile or of a 16-byte vector, H and W smaller than one tile,
    odd and even sizes; two launches give the same bits, and the Python
    plan is the launcher's."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    g = torch.Generator(device=dev).manual_seed(23)
    for shape in ((2, 40, 37, 45), (1, 67, 5, 3), (3, 72, 16, 24),
                  (2, 130, 9, 70)):
        x = torch.randn(*shape, generator=g, device=dev).to(dtype) \
            .contiguous(memory_format=fmt)
        gr = torch.randn(*shape, generator=g, device=dev).to(dtype) \
            .contiguous(memory_format=fmt)
        got = dw_wgrad_cuda(x, gr, k, d)
        ref = dw_wgrad_reference(x, gr, k, d)
        assert got.shape == (k * k, shape[1]) and got.dtype == torch.float32
        err = (got - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item(), (shape, err)
        assert torch.equal(got, dw_wgrad_cuda(x, gr, k, d)), shape
        plan = wgrad_plan(x.shape, x.stride(), gr.stride(), k, d,
                          x.element_size())
        theirs = launcher_plan(x, gr, k, d)
        fast = "nhwc" if channels_last else "nchw"
        assert plan["design"] == (fast if (k, d) in dw_conv.FAST_KD
                                  else "generic")
        assert {key: plan[key] for key in theirs} == theirs, shape


@pytest.mark.parametrize("k,d,mixed", [(3, 2, False), (7, 2, False),
                                       (5, 1, True), (7, 3, True)])
def test_dw_wgrad_first_design_still_matches_plain(dev, k, d, mixed):
    """Another dilation, or x and g in two memory formats, keep the first
    design; its plan is mirrored too."""
    g = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn(2, 40, 37, 45, generator=g, device=dev) \
        .contiguous(memory_format=torch.channels_last)
    gr = torch.randn(2, 40, 37, 45, generator=g, device=dev)
    if not mixed:
        gr = gr.contiguous(memory_format=torch.channels_last)
    got = dw_wgrad_cuda(x, gr, k, d)
    ref = dw_wgrad_reference(x, gr, k, d)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    plan = wgrad_plan(x.shape, x.stride(), gr.stride(), k, d, 4)
    theirs = launcher_plan(x, gr, k, d)
    assert plan["design"] == "generic"
    assert {key: plan[key] for key in theirs} == theirs


@pytest.mark.parametrize("residual", [False, True], ids=["mlp", "residual"])
@pytest.mark.parametrize("shape", [
    # one shape per width of the int8 wgmma design, H and W no multiples
    # of the 8x8 tile; whole rounds of hidden channels, a partial last
    # round, Ch no multiple of 8; C = 32 keeps the first design
    (2, 21, 19, 64, 96), (2, 21, 19, 128, 256), (2, 21, 19, 256, 72),
    (2, 21, 19, 320, 200), (2, 21, 19, 512, 100), (1, 9, 70, 64, 100),
    (1, 9, 70, 320, 1280), (1, 9, 70, 512, 2048), (1, 3, 5, 64, 64),
    (8, 16, 24, 128, 128), (2, 21, 19, 32, 96)], ids=str)
def test_van_mlp_int8_designs_match_plain(dev, shape, residual):
    """K2q and its residual form in bf16 over the shapes that pick each
    design: within INT8_TOL of the plain version with the kernel's scale
    groups, at most 3% of the elements off by more than 2^-7 of
    themselves."""
    args = _mlp_args(dev, shape, torch.bfloat16, seed=31)
    kernel, plain = (
        (van_mlp_residual_int8_cuda, van_mlp_residual_int8_reference)
        if residual else (van_mlp_int8_cuda, van_mlp_int8_reference))
    got = kernel(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    ref = plain(*args).float()
    diff = (got.float() - ref).abs()
    assert diff.max().item() <= INT8_TOL[torch.bfloat16] * ref.abs().max()
    assert (diff > ref.abs() * 2 ** -7).float().mean().item() <= 0.03
    assert torch.equal(got, kernel(*args))      # same launch, same bits


@pytest.mark.parametrize("c,ch,dtype", [
    (64, 512, torch.bfloat16), (128, 1024, torch.bfloat16),
    (256, 72, torch.bfloat16), (320, 1280, torch.bfloat16),
    (512, 2048, torch.bfloat16), (320, 100, torch.bfloat16),
    (64, 100, torch.bfloat16), (32, 96, torch.bfloat16),
    (20, 40, torch.float32), (320, 64, torch.float32)])
def test_van_mlp_int8_plan_mirrors_the_launcher(dev, c, ch, dtype):
    lib = kernel_library()
    limit = torch.cuda.get_device_properties(dev) \
        .shared_memory_per_block_optin
    plan = kernel_plan(c, ch, dtype, limit, int8=True)
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert lib.rs_van_mlp_int8_design(c, ch, code) == (
        2 if plan["design"] == "wgmma" else 1)
    assert plan["smem"] == lib.rs_van_mlp_int8_smem_bytes(c, ch, code)
    assert plan["scratch"] == lib.rs_van_mlp_int8_scratch_bytes(c, ch, code)
    assert lib.rs_van_mlp_int8_design(48, 96, 1) == 0


@pytest.mark.parametrize("c,ch", [(64, 512), (128, 1024), (256, 72),
                                  (320, 1280), (512, 2048), (320, 200),
                                  (64, 100)])
def test_van_mlp_int8_pack_kernel_equals_python_and_qweight(dev, c, ch):
    """The weight preparation on the card: the packed bytes equal the
    Python version's, and unpacked they are ``qweight``'s, bit for bit."""
    _, w1, b1, wdw, bdw, w2, _ = _mlp_args(dev, (1, 8, 8, c, ch),
                                           torch.bfloat16, seed=32)
    want = van_mlp.pack_int8_weights(w1, b1, wdw, bdw, w2)
    got = torch.empty_like(want)
    err = kernel_library().rs_van_mlp_int8_pack(
        w1.data_ptr(), b1.data_ptr(), wdw.data_ptr(), bdw.data_ptr(),
        w2.data_ptr(), got.data_ptr(), c, ch, 1,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(got, want)
    w1q, sw1, w2q, sw2 = van_mlp.unpack_int8_weights(got, c, ch)
    (q1, s1), (q2, s2) = quant.qweight(w1, 0), quant.qweight(w2, 0)
    assert torch.equal(w1q, q1) and torch.equal(sw1, s1)
    assert torch.equal(w2q, q2) and torch.equal(sw2, s2)


@pytest.mark.parametrize("shape", [
    # one shape per width of the wgmma design of proj1 and tail; pixel
    # counts below, at and past a block's 128 (64 in tail at C = 512), none
    # a multiple of it but one; widths that keep the first design
    (1, 13, 11, 64), (2, 30, 41, 128), (1, 16, 16, 256), (2, 9, 7, 320),
    (1, 15, 13, 512), (1, 1, 1, 320), (8, 16, 16, 64), (1, 5, 5, 32),
    (1, 7, 9, 96)], ids=str)
def test_van_attn_bf16_designs_match_plain(dev, shape):
    args = _attn_args(dev, shape, torch.bfloat16, seed=33)
    got = van_attn_cuda(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _assert_close(got, van_attn_reference(*args), torch.bfloat16)
    assert torch.equal(got, van_attn_cuda(*args))   # same launch, same bits


@pytest.mark.parametrize("c,dtype", [
    (64, torch.bfloat16), (128, torch.bfloat16), (256, torch.bfloat16),
    (320, torch.bfloat16), (512, torch.bfloat16), (32, torch.bfloat16),
    (96, torch.bfloat16), (40, torch.float32), (320, torch.float32)])
def test_van_attn_plan_mirrors_the_launcher(dev, c, dtype):
    lib = kernel_library()
    props = torch.cuda.get_device_properties(dev)
    plan = attn_plan(c, dtype, props.shared_memory_per_block_optin,
                     props.shared_memory_per_multiprocessor)
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert lib.rs_van_attn_design(c, code) == (
        2 if plan["design"] == "wgmma" else 1)
    assert max(plan["smem"].values()) == lib.rs_van_attn_smem_bytes(c, code)
    assert plan["scratch"] == lib.rs_van_attn_scratch_bytes(c, code)
    assert lib.rs_van_attn_design(48, 1) == 0


@pytest.mark.parametrize("dtype,c,tol", [(torch.bfloat16, 256, 1e-2),
                                         (torch.float32, 32, 1e-5),
                                         (torch.bfloat16, 36, 1e-2),
                                         (torch.float32, 30, 1e-5)])
def test_roi_align_gather_design_matches_plain(dev, dtype, c, tol):
    """K3's destination-ordered design against autograd of the plain
    forward and against its own plain version (records, stable sort,
    segment sums), with a 16-byte vector per lane and (C = 36, 30) one
    channel per lane; two launches give the same bits."""
    feats, rois = _pyramid(dev, dtype, c, seed=21)
    grad = torch.randn(rois.shape[0], 7, 7, c, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(22)
                       ).to(dtype)
    assert k3_vec(c, dtype) == (1 if c in (30, 36) else 16 // grad
                                .element_size())
    got = roi_align_rotated_pyramid_bwd_cuda(feats, rois, grad)
    again = roi_align_rotated_pyramid_bwd_cuda(feats, rois, grad)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for ref in (roi_align_rotated_pyramid_bwd_reference(feats, rois, grad),
                roi_align_rotated_pyramid_bwd_sorted_reference(feats, rois,
                                                               grad)):
        scale = max(r.float().abs().max().item() for r in ref)
        for a, b in zip(got, ref):
            assert a.dtype == dtype and a.shape == b.shape
            assert (a.float() - b.float()).abs().max().item() <= tol * scale


@pytest.mark.parametrize("dtype,c,tol", [(torch.bfloat16, 256, 1e-2),
                                         (torch.float32, 32, 1e-5),
                                         (torch.float32, 30, 1e-5)])
def test_roi_align_first_design_matches_plain(dev, dtype, c, tol):
    """K3's first design (f32 atomics; a 16-byte vector of g per lane,
    one channel at C = 30), the reference the gather design is timed
    against, against autograd of the plain forward."""
    feats, rois = _pyramid(dev, dtype, c, seed=23)
    grad = torch.randn(rois.shape[0], 7, 7, c, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(24)
                       ).to(dtype)
    got = roi_align_rotated_pyramid_bwd_first_design(feats, rois, grad)
    torch.cuda.synchronize()
    ref = roi_align_rotated_pyramid_bwd_reference(feats, rois, grad)
    scale = max(r.float().abs().max().item() for r in ref)
    for a, b in zip(got, ref):
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


def test_roi_align_gather_design_on_clustered_rois(dev):
    """Rois piled on a few boxes (long runs per pixel, clamped samples at
    the borders, rois past the image): the gather design against the
    plain backward, the same bits over two launches, adjoint to K1."""
    feats, rois = _pyramid(dev, torch.float32, 32, seed=25, r=400)
    rois[:, 1:] = rois[:8, 1:].repeat(50, 1)
    rois[::7, 1:3] = torch.tensor([-20.0, 270.0], device=dev)
    grad = torch.randn(rois.shape[0], 7, 7, 32, device=dev)
    got = roi_align_rotated_pyramid_bwd_cuda(feats, rois, grad)
    again = roi_align_rotated_pyramid_bwd_cuda(feats, rois, grad)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = roi_align_rotated_pyramid_bwd_reference(feats, rois, grad)
    scale = max(r.abs().max().item() for r in ref)
    for a, b in zip(got, ref):
        assert (a - b).abs().max().item() <= 1e-5 * scale
    lhs = (roi_align_rotated_pyramid_cuda(feats, rois).double()
           * grad.double()).sum()
    rhs = sum((f.double() * d.double()).sum() for f, d in zip(feats, got))
    assert abs(lhs - rhs).item() <= 1e-5 * abs(lhs).item()


@pytest.mark.parametrize("k,d", [(5, 1), (7, 3)])
@pytest.mark.parametrize("with_bias", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("shape", [(2, 37, 45, 320), (1, 256, 256, 64),
                                   (1, 64, 64, 320), (1, 32, 32, 512),
                                   (2, 37, 45, 96), (1, 19, 23, 72)])
def test_depthwise_stream_design_matches_conv2d(dev, k, d, with_bias, shape):
    """K5's streaming design against ``F.conv2d`` (f32 tap sums, one
    rounding on both sides): a ragged shape (H, W no multiples of the
    strip or of 4 rows, five channel chunks), the VAN-b3 attention
    shapes at batch 1, and C = 96 and 72, whose last 64-channel chunk is
    partial, with the fused block's ``[C, k*k]`` taps."""
    n, h, w, c = shape
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(n, h, w, c, generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn(c, k * k, generator=g, device=dev) / k) \
        .to(torch.bfloat16)
    bias = (torch.randn(c, generator=g, device=dev) * 0.1) \
        .to(torch.bfloat16) if with_bias else None
    assert dw_plan(k, d, h, w, c, torch.bfloat16, n=n)["design"] == "stream"
    before = depthwise_conv2d_cuda.launches
    got = depthwise_conv2d_cuda(x, wt, k, d, bias=bias, taps_last=True)
    torch.cuda.synchronize()
    assert depthwise_conv2d_cuda.launches == before + 1
    ref = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), wt.reshape(c, 1, k, k), bias,
        padding=d * (k - 1) // 2, dilation=d, groups=c).permute(0, 2, 3, 1)
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * scale
    first = depthwise_conv2d_first_design(x, wt, k, d, bias=bias,
                                          taps_last=True)
    assert (first.float() - ref.float()).abs().max().item() <= 1e-2 * scale


@pytest.mark.parametrize("k,d,h,c,dtype,hcw", [
    (5, 1, 256, 64, torch.bfloat16, False), (7, 3, 256, 64, torch.bfloat16,
                                             False),
    (7, 3, 64, 320, torch.bfloat16, False), (3, 1, 64, 1280, torch.bfloat16,
                                             False),
    (7, 3, 37, 40, torch.float32, False), (7, 3, 256, 64, torch.bfloat16,
                                           True)])
def test_dw_plan_mirrors_the_launchers(dev, k, d, h, c, dtype, hcw):
    lib = kernel_library()
    plan = dw_plan(k, d, h, h, c, dtype, n=8, hcw=hcw)
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    if plan["design"] == "stream":
        assert plan["smem"] == lib.rs_dw_conv_fwd_stream_smem_bytes(
            k, d, plan["groups"])
    elif plan["design"] == "chw":   # K7's form: no shared memory
        assert plan["smem"] == 0 and hcw
    else:
        assert plan["smem"] == lib.rs_dw_conv_fwd_smem_bytes(
            k, plan["rows"], d, code, int(hcw))
    assert lib.rs_dw_conv_fwd_stream_smem_bytes(3, 1, 8) == 0


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 256),
                                     (torch.bfloat16, 40),
                                     (torch.float32, 32),
                                     (torch.bfloat16, 512)])
def test_roi_align_row_design_matches_plain(dev, dtype, c):
    """K1's row design (a warp per row of bins, 16-byte vectors; C = 40:
    five vectors, the other lanes idle; C = 512: two vectors a lane)
    against the plain forward and against its first design, one count
    per launch, the same bits over two launches."""
    feats, rois = _pyramid(dev, dtype, c, seed=31)
    assert _roi_align.k1_plan(c, dtype, rois=rois.shape[0])["design"] \
        == "rows"
    before = roi_align_rotated_pyramid_cuda.launches
    got = roi_align_rotated_pyramid_cuda(feats, rois)
    again = roi_align_rotated_pyramid_cuda(feats, rois)
    torch.cuda.synchronize()
    assert roi_align_rotated_pyramid_cuda.launches == before + 2
    assert torch.equal(got, again)
    _assert_close(got, roi_align_rotated_pyramid_reference(feats, rois),
                  dtype)
    first = _roi_align.roi_align_rotated_pyramid_first_design(feats, rois)
    assert roi_align_rotated_pyramid_cuda.launches == before + 2
    _assert_close(got, first, dtype)


def test_k1_plan_mirrors_the_launcher(dev):
    lib = kernel_library()
    for p, s in ((7, 2), (7, 1), (14, 2)):
        plan = _roi_align.k1_plan(256, torch.bfloat16, p, s, rois=10)
        assert plan["smem"] == lib.rs_roi_align_rows_smem_bytes(p, s)
    for n, sizes in ((8, [(256, 256), (128, 128), (64, 64), (32, 32)]),
                     (2, [(37, 45), (19, 23)])):
        hw = [v for hw_ in sizes for v in hw_] + [1] * (8 - 2 * len(sizes))
        assert _roi_align.k1_bucket_count(n, sizes) \
            == lib.rs_roi_align_rows_buckets(len(sizes), n, *hw)


def test_k1_order_kernel_takes_the_rois_bucket_by_bucket(dev):
    """The order kernel's output is a permutation of the rois whose plain
    buckets (``k1_buckets``) never decrease; with it the row design gives
    the same bits as with the rois as given."""
    feats, rois = _pyramid(dev, torch.bfloat16, 256, seed=33, r=9000)
    lib = kernel_library()
    hw = [v for f in feats for v in f.shape[1:3]]
    order = _roi_align._k1_order(lib, feats, 2, hw, [4.0, 8.0, 16.0, 32.0],
                                 rois, 56.0,
                                 torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.equal(order.sort().values,
                       torch.arange(9000, device=dev))
    bucket, _ = _roi_align.k1_buckets(feats, rois)
    assert (bucket[order].diff() >= 0).all()
    assert _roi_align.k1_plan(256, torch.bfloat16, rois=9000)["sort"]
    got = roi_align_rotated_pyramid_cuda(feats, rois)
    rows = [roi_align_rotated_pyramid_cuda(feats, rois[i:i + 1000])
            for i in range(0, 9000, 1000)]   # fewer than K1_SORT_MIN each
    assert torch.equal(got, torch.cat(rows))


@pytest.mark.parametrize("k,d", [(3, 1), (5, 1), (7, 3), (5, 2)])
@pytest.mark.parametrize("shape", [(2, 37, 64, 200), (1, 40, 64, 264),
                                   (2, 19, 72, 256), (1, 256, 64, 256)])
def test_dw_chw_row_design_matches_plain(dev, k, d, shape):
    """The row-streaming design of K7's form against ``F.conv2d`` (f32
    tap sums, one rounding on both sides: one bf16 ulp of the largest
    value): W short of a strip, W = 264 (a second strip), C = 72, H = 37
    and 19, the prototype's H and W; the first design beside it."""
    n, h, c, w = shape
    g = torch.Generator(device=dev).manual_seed(32)
    x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    wts = (torch.randn(c, k * k, generator=g, device=dev) / k) \
        .to(torch.bfloat16)
    assert dw_plan(k, d, h, w, c, torch.bfloat16, n=n, hcw=True)["design"] \
        == "chw"
    before = dw_chw_cuda.launches
    got = dw_chw_cuda(x, wts, k, d)
    torch.cuda.synchronize()
    assert dw_chw_cuda.launches == before + 1
    ref = dw_chw_reference(x, wts, k, d)
    scale = ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= 1e-2 * scale
    first = _dwconv.dw_chw_first_design(x, wts, k, d)
    assert dw_chw_cuda.launches == before + 1
    assert (first.float() - ref.float()).abs().max().item() <= 1e-2 * scale


def _runner_on(device, tiles_dir, work_dir):
    """The tiny flagship config served by ``Runner`` (flip TTA, FAIR1M-1.5
    merge) from ``work_dir``'s parent, the merge's working directory."""
    from rs_detection_tpu_torch.config import get_cfg
    from rs_detection_tpu_torch.flagship import PIXEL_MEAN, PIXEL_STD
    from rs_detection_tpu_torch.runner import Runner

    cfg = get_cfg()
    cfg.clear()
    cfg.update(dict(
        name="tiny", work_dir=str(work_dir), seed=4,
        model=flagship_cfg(tiny=True),
        dataset=dict(test=dict(
            type="ImageDataset", images_dir=str(tiles_dir),
            dataset_type="FAIR1M_1_5", batch_size=2,
            transforms=[dict(type="RotatedResize", min_size=128, max_size=128),
                        dict(type="Normalize", mean=list(PIXEL_MEAN),
                             std=list(PIXEL_STD), to_bgr=False)])),
        optimizer=dict(type="AdamW", lr=1e-4),
        merge_cfg=dict(dataset_type="FAIR1M_1_5")))
    os.makedirs(work_dir, exist_ok=True)
    os.chdir(os.path.dirname(work_dir))
    return Runner(device=device)


def test_runner_test_task_cuda_matches_cpu(dev, tmp_path, monkeypatch):
    """``Runner.test`` with flip TTA on the card (K1 and K2 launched)
    and on the CPU from one config and seed: dense outputs within the
    tiny predict's tolerances (polys 1e-2 px, scores 1e-5), and the
    merge of one pickle twice gives identical files."""
    import numpy as np
    from PIL import Image

    from rs_detection_tpu_torch.data.devkits.data_merge import \
        data_merge_result
    from rs_detection_tpu_torch.ops.roi_align import \
        roi_align_rotated_pyramid_cuda as k1
    from rs_detection_tpu_torch.ops.van_mlp import van_mlp_cuda as k2

    monkeypatch.chdir(tmp_path)
    tiles = tmp_path / "tiles"
    tiles.mkdir()
    rng = np.random.RandomState(8)
    for name in ("P0001__1.0__0___0.png", "P0001__1.0__64___0.png"):
        Image.fromarray(rng.randint(0, 256, (128, 128, 3)).astype(
            np.uint8)).save(tiles / name)
    gpu = _runner_on(None, tiles, tmp_path / "gpu" / "work")
    cpu = _runner_on("cpu", tiles, tmp_path / "cpu" / "work")
    assert gpu.device.type == "cuda"
    k1.launches = k2.launches = 0
    gpu.test(flip_test=True)
    assert (k1.launches, k2.launches) == (4, 4 * 5)  # 4 flips, batch 2
    for mode in (None, "HV"):
        for images, targets, _ in gpu.test_dataset.batches(mode):
            got, ref = gpu.predict(images, targets), cpu.predict(images,
                                                                 targets)
            assert (got["valid"] == ref["valid"]).all()
            for key, atol in (("polys", 1e-2), ("scores", 1e-5)):
                assert np.abs(got[key] - ref[key]).max() <= atol, key
    pkl = str(tmp_path / "gpu" / "work" / "test" / "test_0.pkl")
    os.chdir(tmp_path / "cpu")
    data_merge_result(pkl, str(tmp_path / "cpu" / "again"), 0, "tiny",
                      dataset_type="FAIR1M_1_5")
    a = tmp_path / "gpu" / "work" / "test" / "submit_0" / "after_nms"
    b = tmp_path / "cpu" / "again" / "test" / "submit_0" / "after_nms"
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        assert (a / name).read_bytes() == (b / name).read_bytes()
