"""The port's CUDA kernels against their plain PyTorch versions, on a
CUDA GPU: ``python -m pytest -m cuda --noconftest
tests/test_torch_port_cuda.py`` (``--noconftest`` where jax is not
installed: ``tests/conftest.py`` imports it). Without a GPU every test
here skips; ``chip_smoke.py`` runs the same checks at the flagship
shapes."""

import pytest
import torch

from rs_detection_tpu_torch.flagship import build_flagship, normalize
from rs_detection_tpu_torch.ops.roi_align import (
    roi_align_rotated_pyramid_cuda, roi_align_rotated_pyramid_reference)
from rs_detection_tpu_torch.ops.van_mlp import van_mlp_cuda, van_mlp_reference

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


@pytest.mark.parametrize("dtype,c", [(torch.float32, 16),
                                     (torch.float32, 30),
                                     (torch.bfloat16, 256)])
def test_roi_align_kernel_matches_plain(dev, dtype, c):
    g = torch.Generator(device=dev).manual_seed(1)
    feats = [torch.randn(2, s, s, c, generator=g, device=dev).to(dtype)
             for s in (64, 32, 16, 8)]
    r = 600

    def u(lo, hi):
        return torch.rand(r, generator=g, device=dev) * (hi - lo) + lo

    scale, aspect = torch.exp(u(2.0, 6.8)), torch.exp(u(-1.5, 1.5))
    rois = torch.stack([torch.randint(0, 2, (r,), generator=g,
                                      device=dev).float(),
                        u(-50, 300), u(-50, 300), scale * aspect,
                        scale / aspect, u(-3.2, 3.2)], 1)
    got = roi_align_rotated_pyramid_cuda(feats, rois)
    torch.cuda.synchronize()
    _assert_close(got, roi_align_rotated_pyramid_reference(feats, rois),
                  dtype)


def test_tiny_predict_cuda_matches_cpu(dev):
    tiles = torch.randint(0, 256, (2, 128, 128, 3),
                          generator=torch.Generator().manual_seed(2),
                          dtype=torch.uint8)
    cpu = build_flagship(tiny=True).predict(normalize(tiles))
    gpu = build_flagship(tiny=True, device=dev).predict(
        normalize(tiles.to(dev)))
    assert torch.equal(gpu["valid"].cpu(), cpu["valid"])
    torch.testing.assert_close(gpu["scores"].cpu(), cpu["scores"],
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(gpu["polys"].cpu(), cpu["polys"],
                               rtol=0, atol=1e-2)
