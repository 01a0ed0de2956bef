"""The fused VAN serving mode of the PyTorch port against the JAX
package, on the CPU in f32: the plain versions beside the attention
half-block kernel (K4), the residual form of the MLP kernel (K2r) and
the depthwise forward kernel (K5, with the prototype's CHW form), the
fused ``VANBlock`` and the tiny flagship's fused ``predict``. The JAX
side runs its Pallas kernels in interpret mode. Also the rule that a
wrapper never falls back from a non-CPU tensor, and the device default
of ``build_flagship``."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.models.backbones.van import VANBlock as JVANBlock
from rs_detection_tpu.ops.pallas_dwconv import depthwise_conv2d as jdw
from rs_detection_tpu.ops.pallas_van_attn import _ref_attn
from rs_detection_tpu.ops.pallas_van_attn import van_attn as jvan_attn
from rs_detection_tpu.ops.pallas_van_mlp import \
    van_mlp_residual as jvan_mlp_residual
from rs_detection_tpu_torch.flagship import build_flagship, normalize
from rs_detection_tpu_torch.models.backbones.van import VANBlock
from rs_detection_tpu_torch.models.utils.modules import BatchNorm2d
from rs_detection_tpu_torch.ops.dwconv import (
    depthwise_conv2d, depthwise_conv2d_cuda, depthwise_conv2d_reference,
    dw_chw, dw_chw_cuda, dw_chw_reference)
from rs_detection_tpu_torch.ops.van_attn import (van_attn, van_attn_cuda,
                                                 van_attn_reference)
from rs_detection_tpu_torch.ops.van_mlp import (van_mlp_reference,
                                                van_mlp_residual,
                                                van_mlp_residual_cuda,
                                                van_mlp_residual_reference)
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_kernels import _jax_layout, _mlp_inputs
from test_torch_port_slice import jax_tiny, perturb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("a1", "b1", "wp1", "bp1", "wdw5", "bdw5", "wdw7", "bdw7", "wc1",
         "bc1", "wp2", "bp2", "ls1")


def _attn_weights(c, seed=0):
    """The weights of ``tests/test_pallas_van_attn.py`` in the JAX
    layouts: 1x1 ``[in, out]``, depthwise ``[k*k, C]``."""
    rng = np.random.RandomState(seed)

    def mk(*s, scale=0.1):
        return rng.randn(*s).astype(np.float32) * scale

    return dict(a1=1.0 + mk(c), b1=mk(c), wp1=mk(c, c), bp1=mk(c),
                wdw5=mk(25, c), bdw5=mk(c), wdw7=mk(49, c, scale=0.05),
                bdw7=mk(c), wc1=mk(c, c), bc1=mk(c), wp2=mk(c, c), bp2=mk(c),
                ls1=mk(c, scale=0.01))


def _attn_torch_args(x, wts):
    """The port's ``van_attn`` arguments: ``nn.Conv2d`` layouts."""
    c = x.shape[-1]
    t = torch.from_numpy

    def pw(w):   # [in, out] -> [out, in, 1, 1]
        return t(np.ascontiguousarray(w.T))[:, :, None, None]

    def dw(w, k):  # [k*k, C] -> [C, 1, k, k]
        return t(np.ascontiguousarray(w.T)).reshape(c, 1, k, k)

    return (t(x), t(wts["a1"]), t(wts["b1"]), pw(wts["wp1"]), t(wts["bp1"]),
            dw(wts["wdw5"], 5), t(wts["bdw5"]), dw(wts["wdw7"], 7),
            t(wts["bdw7"]), pw(wts["wc1"]), t(wts["bc1"]), pw(wts["wp2"]),
            t(wts["bp2"]), t(wts["ls1"]))


@pytest.mark.parametrize("jax_fn", [
    _ref_attn, lambda *a: jvan_attn(*a, block_rows=8)],
    ids=["ref_attn", "pallas_interpret"])
@pytest.mark.parametrize("shape", [(1, 16, 16, 32), (2, 24, 20, 32),
                                   (1, 13, 16, 32)])
def test_van_attn_reference_matches_jax(shape, jax_fn):
    rng = np.random.RandomState(1)
    x = rng.randn(*shape).astype(np.float32) * 0.5
    wts = _attn_weights(shape[-1])
    got = van_attn_reference(*_attn_torch_args(x, wts))
    ref = np.asarray(jax_fn(jnp.asarray(x),
                            *(jnp.asarray(wts[k]) for k in ORDER)))
    # the tolerance of the JAX package's own kernel test: f32 sums in
    # another order, and the JAX GELU's 1.5e-7 erf polynomial
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_van_mlp_residual_reference_matches_jax():
    args = _mlp_inputs(6)
    got = van_mlp_residual_reference(*(torch.from_numpy(a) for a in args))
    ref = np.asarray(jvan_mlp_residual(*_jax_layout(*args)))  # interpret
    # f32 on both sides: summation order and the erf polynomial; O(1)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)
    plain = van_mlp_reference(*(torch.from_numpy(a) for a in args))
    torch.testing.assert_close(got, torch.from_numpy(args[0]) + plain,
                               rtol=0, atol=1e-6)


def test_folded_affine_is_the_eval_norm():
    rng = np.random.RandomState(7)
    bn = BatchNorm2d(6).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.rand(6).astype(np.float32) + .5))
        bn.bias.copy_(torch.from_numpy(rng.randn(6).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(
            rng.randn(6).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.rand(6).astype(np.float32) + .5))
    x = torch.from_numpy(rng.randn(2, 6, 5, 4).astype(np.float32))
    a, b = bn.folded_affine()
    assert a.dtype == b.dtype == torch.float32
    # f32, one multiply-add against subtract, divide, multiply, add
    torch.testing.assert_close(a.view(1, -1, 1, 1) * x + b.view(1, -1, 1, 1),
                               bn(x), rtol=1e-6, atol=1e-6)


@pytest.fixture
def block_pair():
    """A JAX ``VANBlock`` with randomized BN statistics, biases and
    layer scales, and its flax tree loaded into a fused and a non-fused
    port block."""
    jblock = JVANBlock(dim=32, mlp_ratio=4.0)
    rng = np.random.RandomState(2)
    x = rng.randn(1, 16, 16, 32).astype(np.float32) * 0.5
    variables = perturb(jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                        seed=5)
    blocks = [load_jax_variables(VANBlock(32, 4.0, fused=f).eval(), variables)
              for f in (True, False)]
    return jblock, variables, x, blocks


def test_fused_block_matches_jax_fused_block(block_pair, monkeypatch):
    jblock, variables, x, (fused, plain) = block_pair
    monkeypatch.setenv("RS_VAN_FUSED_FORCE", "1")
    ref = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = fused(xt).permute(0, 2, 3, 1)
        unfused = plain(xt).permute(0, 2, 3, 1)
    # the tolerance of the JAX package's fused-block test (f32; the
    # folds reassociate the bn2 affine and the layer scale)
    np.testing.assert_allclose(got.numpy(), ref, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), rtol=5e-4,
                               atol=5e-4)
    assert np.abs(unfused.numpy() - x).max() > 0.05  # the block does work


def test_fused_flag_is_ignored_in_training(block_pair):
    _, _, x, (fused, plain) = block_pair
    xt = torch.from_numpy(np.concatenate([x, x[:, ::-1]])).permute(0, 3, 1, 2)
    fused.train()
    plain.train()
    a, b = fused(xt), plain(xt)
    assert a.grad_fn is not None          # the differentiable path
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(fused.norm1.running_mean,
                               plain.norm1.running_mean, rtol=0, atol=0)


def test_tiny_fused_predict_matches_jax_fused(monkeypatch):
    """One flax tree in the JAX tiny flagship under ``RS_VAN_FUSED_FORCE``
    (Pallas kernels in interpret mode) and in the port's fused tiny
    flagship. Tolerances as ``test_tiny_predict_matches_jax`` with room
    for the folds: both sides are f32."""
    model = jax_tiny()
    variables = jax.jit(lambda i: model.init(
        {"params": jax.random.PRNGKey(0)}, i))(
            jnp.zeros((1, 128, 128, 3), jnp.float32))
    variables = perturb(variables, seed=3)
    port = build_flagship(tiny=True, device="cpu", fused=True)
    load_jax_variables(port, variables)
    assert all(b.fused for b in port.backbone.modules()
               if isinstance(b, VANBlock))
    rng = np.random.RandomState(11)
    tiles = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    images = normalize(torch.from_numpy(tiles))
    got = port.predict(images)
    monkeypatch.setenv("RS_VAN_FUSED_FORCE", "1")
    ref = jax.jit(lambda v, i: model.apply(v, i, method=model.predict))(
        variables, jnp.asarray(images.numpy()))
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 32
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["polys"].numpy(),
                               np.asarray(ref["polys"]), atol=5e-3)
    # and the port's own non-fused mode, same weights
    plain = load_jax_variables(build_flagship(tiny=True, device="cpu"),
                               variables).predict(images)
    np.testing.assert_array_equal(plain["valid"].numpy(), valid)
    np.testing.assert_allclose(got["scores"].numpy(),
                               plain["scores"].numpy(), atol=1e-5)


@pytest.mark.parametrize("k,d,c", [(3, 1, 8), (5, 1, 16), (7, 3, 16)])
def test_depthwise_conv2d_matches_jax(k, d, c):
    """Forward and both gradients against the JAX op (Pallas forward in
    interpret mode, its custom vjp). f32; sums of up to 49 taps forward
    and 2 * 24 * 20 products in ``dw``, values in [0, 1)."""
    rng = np.random.RandomState(1)
    x = rng.rand(2, 24, 20, c).astype(np.float32)
    w = rng.rand(k, k, c).astype(np.float32)
    g = rng.randn(2, 24, 20, c).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b: jdw(a, b, k, d), jnp.asarray(x),
                       jnp.asarray(w))
    rdx, rdw = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    got = depthwise_conv2d(xt, wt, k, d)
    dx, dw = torch.autograd.grad(got, (xt, wt), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), atol=1e-4)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw), rtol=1e-4,
                               atol=1e-3)
    torch.testing.assert_close(
        got.detach(), depthwise_conv2d_reference(xt.detach(), wt.detach(),
                                                 k, d), rtol=0, atol=0)


@pytest.mark.parametrize("k,dil", [(5, 1), (7, 3)])
def test_dw_chw_matches_jax_prototype(k, dil):
    spec = importlib.util.spec_from_file_location(
        "chw_dw_proto", os.path.join(REPO, "tools", "analysis_tools",
                                     "chw_dw_proto.py"))
    proto = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proto)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 19, 12, 24).astype(np.float32)      # [N, H, C, W]
    wts = (rng.randn(12, k * k) * 0.1).astype(np.float32)
    ref = np.asarray(proto.dw_chw(jnp.asarray(x), jnp.asarray(wts), k, dil,
                                  bh=8, interpret=True))
    got = dw_chw(torch.from_numpy(x), torch.from_numpy(wts), k, dil)
    # f32 sums of up to 49 taps in another order
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)
    # the same function as the NHWC op, transposed
    nhwc = depthwise_conv2d_reference(
        torch.from_numpy(x).permute(0, 1, 3, 2),
        torch.from_numpy(wts).t().reshape(k, k, 12), k, dil)
    torch.testing.assert_close(got, nhwc.permute(0, 1, 3, 2), rtol=1e-5,
                               atol=1e-5)


def _dispatch_cases():
    rng = np.random.RandomState(4)
    x = rng.randn(1, 9, 8, 32).astype(np.float32)
    attn = _attn_torch_args(x, _attn_weights(32))
    mlp = [torch.from_numpy(a) for a in _mlp_inputs(5)]
    dwx = torch.from_numpy(x)
    dww = torch.from_numpy(rng.randn(5, 5, 32).astype(np.float32))
    chw = (dwx.permute(0, 1, 3, 2).contiguous(),
           torch.from_numpy(rng.randn(32, 25).astype(np.float32)))
    return {
        "van_attn": (van_attn, van_attn_cuda, van_attn_reference, attn, ()),
        "van_mlp_residual": (van_mlp_residual, van_mlp_residual_cuda,
                             van_mlp_residual_reference, mlp, ()),
        "depthwise_conv2d": (depthwise_conv2d, depthwise_conv2d_cuda,
                             depthwise_conv2d_reference, (dwx, dww), (5, 1)),
        "dw_chw": (dw_chw, dw_chw_cuda, dw_chw_reference, chw, (5, 1)),
    }


@pytest.mark.parametrize("name", ["van_attn", "van_mlp_residual",
                                  "depthwise_conv2d", "dw_chw"])
def test_dispatch_cpu_and_no_fallback(name):
    fn, cuda_fn, reference, tensors, rest = _dispatch_cases()[name]
    torch.testing.assert_close(fn(*tensors, *rest),
                               reference(*tensors, *rest), rtol=0, atol=0)
    before = cuda_fn.launches
    with pytest.raises(ValueError):
        cuda_fn(*tensors, *rest)      # CPU tensors never reach a kernel
    with pytest.raises(ValueError):
        fn(*(t.to("meta") for t in tensors), *rest)
    assert cuda_fn.launches == before


def test_build_flagship_defaults_to_the_card():
    if torch.cuda.is_available():
        model = build_flagship(tiny=True)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_flagship(tiny=True)
    cpu = build_flagship(tiny=True, device="cpu")
    assert next(cpu.parameters()).device.type == "cpu"
    assert not any(b.fused for b in cpu.backbone.modules()
                   if isinstance(b, VANBlock))
