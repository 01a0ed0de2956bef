"""The int8 serving mode of the PyTorch port against the JAX package
(``RS_INT8=1`` there, constructor flags here), on the CPU in f32:
``ops/quant.py`` value for value, the plain version of the int8 MLP in
each of its three activation-scale groups (the JAX ``_int8_mlp``, the
Pallas kernel in interpret mode, and an independent per-tile loop for
the CUDA kernel's group), ``sa_core``, the VAN, FPN and RPN modules and
the tiny flagship's ``predict`` in both serving modes from one flax
tree.

A quantizer is a step function: where the two packages' f32 arithmetic
differs in the last bits (summation order, the JAX erf polynomial's
1.5e-7), a value next to a rounding boundary lands one int8 step apart.
The s8 values and s32 sums of a single op are compared bit for bit; a
chain of ops is compared with the bound stated from the step size.

``RS_INT8`` is read when JAX traces: every test sets it before the first
``apply`` and builds its own jitted callables.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rs_detection_tpu.models.backbones.van import VAN as JVAN
from rs_detection_tpu.models.backbones.van import VANBlock as JVANBlock
from rs_detection_tpu.models.necks.fpn import FPN as JFPN
from rs_detection_tpu.models.roi_heads.oriented_rpn_head import \
    OrientedRPNHead as JRPN
from rs_detection_tpu.ops import quant as jquant
from rs_detection_tpu.ops.pallas_van_attn import _sa_core
from rs_detection_tpu.ops.pallas_van_mlp import _int8_mlp
from rs_detection_tpu.ops.pallas_van_mlp import van_mlp as jvan_mlp
from rs_detection_tpu.ops.pallas_van_mlp import \
    van_mlp_residual as jvan_mlp_residual
from rs_detection_tpu_torch.flagship import build_flagship, normalize
from rs_detection_tpu_torch.models.backbones.van import VAN, Mlp, VANBlock
from rs_detection_tpu_torch.models.necks.fpn import FPN
from rs_detection_tpu_torch.models.roi_heads.oriented_rpn_head import \
    OrientedRPNHead
from rs_detection_tpu_torch.models.utils.modules import (conv2d,
                                                         maybe_int8_conv2d)
from rs_detection_tpu_torch.ops import quant
from rs_detection_tpu_torch.ops.van_attn import sa_core
from rs_detection_tpu_torch.ops.van_mlp import (
    CHUNK, TILE, van_mlp_int8, van_mlp_int8_cuda, van_mlp_int8_reference,
    van_mlp_reference, van_mlp_residual_int8, van_mlp_residual_int8_cuda,
    van_mlp_residual_int8_reference)
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_port_kernels import _jax_layout, _mlp_inputs
from test_torch_port_modules import ANCHORS, _init, _j, _nhwc, _t
from test_torch_port_slice import jax_tiny, perturb
from torch_one_thread import _one_thread  # noqa: F401

DIMS = (16, 32, 40, 64)


def _set_group(model, group):
    for m in model.modules():
        if isinstance(m, Mlp):
            m.int8_group = group
    return model


def _steps_apart(got, ref, step, share=0.02, steps=4):
    """``got`` and ``ref`` went through the same quantizers with f32
    noise between them: all but ``share`` of the elements agree to 1e-5
    of the largest value, and none is further than ``steps`` quantizer
    steps of size ``step`` away."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    diff = np.abs(got - ref)
    scale = np.abs(ref).max()
    assert diff.max() <= steps * step, (diff.max(), step)
    assert (diff > 1e-5 * scale).mean() <= share, (diff > 1e-5 * scale).mean()


# --- ops/quant.py ----------------------------------------------------------

def test_qact_and_qweight_match_jax_bit_for_bit():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 9, 7, 24) * 2.5).astype(np.float32)
    q, s = quant.qact(torch.from_numpy(x))
    jq, js = jquant._qact(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    # the zero tensor: scale 1, all-zero values
    q, s = quant.qact(torch.zeros(2, 5))
    assert float(s) == 1.0 and not q.any()
    # per output channel; a zero channel gets scale 1
    w = rng.randn(24, 40).astype(np.float32)      # JAX [in, out]
    w[:, 3] = 0.0
    jq, js = jquant._qweight(jnp.asarray(w), axis=-1)
    q, s = quant.qweight(torch.from_numpy(np.ascontiguousarray(w.T)), 0)
    np.testing.assert_array_equal(q.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[3] == 1.0


def test_int8_channel_matmul_matches_jax():
    """The shape of the JAX package's own test. s32 sums bit-equal;
    outputs to 1e-6 relative (one f32 multiply and add each side)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 33, 33, 96).astype(np.float32)
    w = (rng.randn(96, 128) * 0.05).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    jq, _ = jquant._qact(jnp.asarray(x))
    jwq, _ = jquant._qweight(jnp.asarray(w), axis=-1)
    jacc = jax.lax.dot_general(jq.reshape(-1, 96), jwq,
                               (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    wt = torch.from_numpy(np.ascontiguousarray(w.T))
    xq, _ = quant.qact(torch.from_numpy(x))
    wq, _ = quant.qweight(wt, 0)
    acc = quant.int_matmul(xq.reshape(-1, 96), wq.t())
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = quant.int8_channel_matmul(torch.from_numpy(x), wt,
                                    torch.from_numpy(b))
    ref = np.asarray(jquant.int8_channel_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    # and it is an int8 product: ~1% of the dynamic range from float
    fp = x @ w + b
    assert 1e-3 < np.abs(got.numpy() - fp).max() / np.abs(fp).max() < 0.03


def test_int_matmul_pads_nothing_into_the_sum():
    """Shapes cuBLASLt refuses unpadded (M <= 16, ragged K and N) and the
    empty product; on the CPU the padding path is not taken, so this pins
    the values the CUDA path must reproduce."""
    rng = np.random.RandomState(1)
    for m, k, n in ((5, 12, 7), (16, 40, 24), (1001, 36, 20), (0, 8, 8)):
        a = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
        got = quant.int_matmul(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, a.int() @ b.int())


@pytest.mark.parametrize("k,stride,pad,cin", [(3, 1, 1, 64), (3, 2, 1, 16),
                                              (1, 1, 0, 40), (7, 4, 3, 16)])
def test_int8_conv_matches_jax(k, stride, pad, cin):
    """s32 sums bit-equal to the JAX integer conv and to torch's own
    integer conv; outputs to 1e-6; the all-zero input gives the bias."""
    rng = np.random.RandomState(1)
    cout = 32
    x = rng.randn(2, 17, 16, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.06).astype(np.float32)   # HWIO
    b = rng.randn(cout).astype(np.float32)
    pads = [(pad, pad), (pad, pad)]
    jq, _ = jquant._qact(jnp.asarray(x))
    jwq, _ = jquant._qweight(jnp.asarray(w), axis=-1)
    jacc = jax.lax.conv_general_dilated(
        jq, jwq, (stride, stride), pads,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x)
    xq, _ = quant.qact(xt)
    wq, _ = quant.qweight(wt, 0)
    acc = quant.int_conv2d(xq, wq, (stride, stride), (pad, pad))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    lib = F.conv2d(xq.permute(0, 3, 1, 2).int(), wq.int(), None, stride, pad)
    assert torch.equal(acc, lib.permute(0, 2, 3, 1))
    nchw = xt.permute(0, 3, 1, 2)
    got = quant.int8_conv(nchw, wt, torch.from_numpy(b), (stride, stride),
                          (pad, pad))
    ref = np.asarray(jquant.int8_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        strides=(stride, stride), padding=pads))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=1e-6, atol=1e-6)
    zero = quant.int8_conv(torch.zeros_like(nchw), wt, torch.from_numpy(b),
                           (stride, stride), (pad, pad))
    assert torch.isfinite(zero).all()
    np.testing.assert_allclose(
        zero.numpy(), np.broadcast_to(b[None, :, None, None], zero.shape),
        atol=1e-6)


def test_maybe_int8_conv2d_is_a_drop_in():
    """The same parameters either way; fewer than 16 input channels (the
    RGB stem) stay float under the flag; dilated or grouped convs are
    refused."""
    torch.manual_seed(0)
    stem = torch.nn.Conv2d(3, 8, 7, 4, 3)
    x3 = torch.randn(2, 3, 20, 20)
    assert torch.equal(maybe_int8_conv2d(stem, x3, True), conv2d(stem, x3))
    wide = torch.nn.Conv2d(16, 8, 3, 2, 1)
    x16 = torch.randn(2, 16, 20, 20)
    assert torch.equal(maybe_int8_conv2d(wide, x16, False), conv2d(wide, x16))
    got = maybe_int8_conv2d(wide, x16, True)
    assert torch.equal(got, quant.int8_conv(x16, wide.weight, wide.bias,
                                            (2, 2), (1, 1)))
    rel = (got - conv2d(wide, x16)).abs().max() / conv2d(wide, x16).abs().max()
    assert 1e-4 < rel < 0.03
    with pytest.raises(ValueError, match="dense"):
        maybe_int8_conv2d(torch.nn.Conv2d(16, 16, 3, padding=1, groups=16),
                          x16, True)


# --- the int8 MLP in its three scale groups --------------------------------

def test_int8_mlp_tensor_group_matches_jax_int8_mlp():
    args = _mlp_inputs(3, n=2, h=12, w=10, c=32, ch=64)
    ref = np.asarray(_int8_mlp(*_jax_layout(*args)))
    got = van_mlp_int8_reference(*(torch.from_numpy(a) for a in args),
                                 group="tensor")
    fp = van_mlp_reference(*(torch.from_numpy(a) for a in args))
    # the hidden tensor's step: fc2 sums 64 of them times weights ~1/8
    step = float(fp.abs().max()) / 127
    _steps_apart(got.numpy(), ref, step)
    assert 1e-3 < float((got - fp).abs().max() / fp.abs().max()) < 0.04


@pytest.mark.parametrize("residual", [False, True], ids=["mlp", "residual"])
def test_int8_mlp_row_blocks_match_pallas_interpret(residual, monkeypatch):
    """[2, 64, 12, 16] with hidden 64: the TPU kernel picks bh = 32, two
    row blocks per image, so the per-block scales differ from per-tensor
    ones (the tensor group is further away than the step bound below
    only allows in a few elements, which the last assertion pins)."""
    monkeypatch.setenv("RS_INT8", "1")
    args = _mlp_inputs(4, n=2, h=64, w=12, c=16, ch=64)
    jfn = jvan_mlp_residual if residual else jvan_mlp
    ref = np.asarray(jfn(*_jax_layout(*args)))            # interpret mode
    fn = van_mlp_residual_int8_reference if residual \
        else van_mlp_int8_reference
    tensors = [torch.from_numpy(a) for a in args]
    got = fn(*tensors, group=("rows", 32))
    fp = van_mlp_reference(*tensors)
    step = float(fp.abs().max()) / 127
    _steps_apart(got.numpy(), ref, step)
    # the groupings are told apart: per-tensor scales give other values
    other = fn(*tensors, group="tensor")
    assert (np.abs(other.numpy() - ref) > 1e-5 * np.abs(ref).max()).mean() \
        > 0.5
    if residual:
        plain = van_mlp_int8_reference(*tensors, group=("rows", 32))
        torch.testing.assert_close(got, tensors[0] + plain, rtol=0,
                                   atol=1e-6)


def _tile_loop(x, w1, b1, wdw, bdw, w2, b2, residual):
    """The CUDA kernel's arithmetic written tile by tile and chunk by
    chunk, independent of the unfolded plain version."""
    n, h, w, c = x.shape
    ch = w1.shape[0]

    def qw(m):
        s = m.abs().amax(1, keepdim=True)
        s = torch.where(s > 0, s / 127.0, torch.ones_like(s))
        return torch.clamp(torch.round(m / s), -127, 127), s[:, 0]

    def q(t):
        amax = t.abs().max()
        s = amax / 127.0 if amax > 0 else torch.tensor(1.0)
        return torch.clamp(torch.round(t * (1.0 / s)), -127, 127), s

    w1q, sw1 = qw(w1)
    w2q, sw2 = qw(w2)
    y = torch.zeros_like(x)
    for i in range(n):
        for ty in range(0, h, TILE):
            for tx in range(0, w, TILE):
                patch = torch.zeros(TILE + 2, TILE + 2, c)
                inside = torch.zeros(TILE + 2, TILE + 2, dtype=torch.bool)
                for py in range(TILE + 2):
                    for px in range(TILE + 2):
                        gy, gx = ty - 1 + py, tx - 1 + px
                        if 0 <= gy < h and 0 <= gx < w:
                            patch[py, px] = x[i, gy, gx]
                            inside[py, px] = True
                xq, sx = q(patch)
                acc = (xq.double() @ w1q.double().t()).float()   # exact
                h1 = acc * (sx * sw1) + b1
                h1 = torch.where(inside[..., None], h1, torch.zeros(()))
                out = torch.zeros(TILE, TILE, c)
                for k0 in range(0, ch, CHUNK):
                    k1 = min(k0 + CHUNK, ch)
                    pre = None
                    for dx in range(3):
                        for dy in range(3):
                            tap = h1[dy:dy + TILE, dx:dx + TILE, k0:k1] \
                                * wdw[k0:k1, dy * 3 + dx]
                            pre = tap if pre is None else pre + tap
                    g = F.gelu(pre + bdw[k0:k1])
                    g = torch.where(inside[1:-1, 1:-1, None], g,
                                    torch.zeros(()))
                    gq, sg = q(g)
                    part = (gq.double() @ w2q[:, k0:k1].double().t()).float()
                    out = out + sg * part
                out = out * sw2 + b2
                ey, ex = min(ty + TILE, h), min(tx + TILE, w)
                y[i, ty:ey, tx:ex] = out[:ey - ty, :ex - tx]
    return x + y if residual else y


@pytest.mark.parametrize("residual", [False, True], ids=["mlp", "residual"])
def test_int8_mlp_tile_group_matches_a_per_tile_loop(residual):
    """H and W no multiples of the tile, Ch no multiple of the chunk: the
    border tiles, the zero padding and the ragged last chunk. The loop
    sums in the plain version's order, so only the integer products'
    route differs: 1e-5 of the largest value."""
    args = [torch.from_numpy(a)
            for a in _mlp_inputs(5, n=2, h=13, w=10, c=12, ch=40)]
    fn = van_mlp_residual_int8_reference if residual \
        else van_mlp_int8_reference
    got = fn(*args)                                    # group="tile"
    ref = _tile_loop(*args, residual)
    scale = float(ref.abs().max())
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * scale)
    # and the tile group is its own: not the tensor group's values
    other = fn(*args, group="tensor")
    assert float((other - ref).abs().max()) > 1e-3 * scale


def test_int8_mlp_groups_are_all_int8_close_to_float():
    args = [torch.from_numpy(a)
            for a in _mlp_inputs(6, n=2, h=21, w=19, c=24, ch=72)]
    fp = van_mlp_reference(*args)
    for group in ("tile", "tensor", ("rows", 8), ("rows", 32)):
        rel = float((van_mlp_int8_reference(*args, group=group) - fp)
                    .abs().max() / fp.abs().max())
        # two int8 quantizations per product: 1-3% of the largest value
        assert 1e-3 < rel < 0.04, (group, rel)
    with pytest.raises(ValueError, match="group"):
        van_mlp_int8_reference(*args, group="block")


@pytest.mark.parametrize("name", ["van_mlp_int8", "van_mlp_residual_int8"])
def test_int8_dispatch_cpu_and_no_fallback(name):
    fn, cuda_fn, reference = {
        "van_mlp_int8": (van_mlp_int8, van_mlp_int8_cuda,
                         van_mlp_int8_reference),
        "van_mlp_residual_int8": (van_mlp_residual_int8,
                                  van_mlp_residual_int8_cuda,
                                  van_mlp_residual_int8_reference)}[name]
    args = [torch.from_numpy(a) for a in _mlp_inputs(7)]
    torch.testing.assert_close(fn(*args), reference(*args, group="tile"),
                               rtol=0, atol=0)
    torch.testing.assert_close(fn(*args, group="tensor"),
                               reference(*args, group="tensor"), rtol=0,
                               atol=0)
    before = cuda_fn.launches
    with pytest.raises(ValueError):
        cuda_fn(*args)               # CPU tensors never reach a kernel
    with pytest.raises(ValueError):
        fn(*(a.to("meta") for a in args))
    assert cuda_fn.launches == before


# --- sa_core and the modules ------------------------------------------------

def test_sa_core_int8_matches_jax(monkeypatch):
    monkeypatch.setenv("RS_INT8", "1")
    rng = np.random.RandomState(2)
    f = np.float32
    c = 16
    h = rng.randn(2, 13, 10, c).astype(f)
    wp1, wc1, wp2 = ((rng.randn(c, c) / np.sqrt(c)).astype(f)
                     for _ in range(3))
    w5 = (rng.randn(25, c) / 5).astype(f)
    w7 = (rng.randn(49, c) / 7).astype(f)
    bp1, b5, b7, bc1, bp2 = (0.2 * rng.randn(c).astype(f) for _ in range(5))
    ref = np.asarray(_sa_core(*(jnp.asarray(a) for a in (
        h, wp1, bp1, w5, b5, w7, b7, wc1, bc1, wp2, bp2))))

    def pw(w):   # [in, out] -> [out, in, 1, 1]
        return torch.from_numpy(np.ascontiguousarray(w.T))[:, :, None, None]

    def dw(w, k):  # [k*k, C] -> [C, 1, k, k]
        return torch.from_numpy(np.ascontiguousarray(w.T)).reshape(c, 1, k, k)

    t = torch.from_numpy
    args = (t(h), pw(wp1), t(bp1), dw(w5, 5), t(b5), dw(w7, 7), t(b7),
            pw(wc1), t(bc1), pw(wp2), t(bp2))
    got = sa_core(*args, int8=True)
    fp = sa_core(*args)
    # three quantized mixes in a row; a step of the last one's input
    _steps_apart(got.numpy(), ref, float(fp.abs().max()) / 127)
    rel = float((got - fp).abs().max() / fp.abs().max())
    assert 1e-3 < rel < 0.06, rel


def test_van_int8_matches_jax(monkeypatch):
    """The JAX VAN on the CPU runs ``_int8_mlp`` (per-tensor scales), so
    the port's MLPs take that group. Five blocks deep, one int8 step set
    off by the packages' f32 noise sets off more downstream, so the
    bound is the chain's: the JAX package's own int8-against-float bound
    per level (0.15 relative, correlation 0.995), tightened to 0.05 and
    0.999; and the port's int8 features are much nearer to the JAX int8
    features than to the float ones unless such a step occurred."""
    monkeypatch.setenv("RS_INT8", "1")
    cfg = dict(embed_dims=DIMS, mlp_ratios=(8, 8, 4, 4), depths=(1, 1, 2, 1))
    jm = JVAN(**cfg)
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    v = _init(jm, 0, jnp.asarray(x))
    port = _set_group(load_jax_variables(VAN(**cfg, int8=True).eval(), v),
                      "tensor")
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
        fp = load_jax_variables(VAN(**cfg).eval(), v)(torch.from_numpy(x))
    for g, r, f in zip(got, ref, fp):
        g, r = g.numpy(), np.asarray(r)
        assert np.abs(g - r).max() / np.abs(r).max() < 0.05
        assert np.corrcoef(g.ravel(), r.ravel())[0, 1] > 0.999
        # the flag changed the features (stage 1's stem is float, its
        # block is not)
        assert float((torch.from_numpy(g) - f).abs().max()) > 1e-4


def test_fpn_int8_matches_jax(monkeypatch):
    monkeypatch.setenv("RS_INT8", "1")
    rng = np.random.RandomState(1)
    feats = _nhwc(rng, [(2, 16, 16, 16), (2, 8, 8, 32), (2, 4, 4, 40),
                        (2, 2, 2, 64)])
    jm = JFPN(in_channels=DIMS, out_channels=24, num_outs=5)
    v = _init(jm, 1, _j(feats))
    port = load_jax_variables(FPN(DIMS, 24, num_outs=5, int8=True).eval(), v)
    ref = jax.jit(jm.apply)(v, _j(feats))
    got = port(_t(feats))
    fp = load_jax_variables(FPN(DIMS, 24, num_outs=5).eval(), v)(_t(feats))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r, f in zip(got, ref, fp):
        _steps_apart(g.detach().numpy(), r, float(f.abs().max()) / 127)
        assert 1e-4 < float((g - f).abs().max() / f.abs().max()) < 0.05


def test_rpn_tower_int8_matches_jax(monkeypatch):
    """The 3x3 tower conv is quantized, ``rpn_cls`` and ``rpn_reg`` are
    not."""
    monkeypatch.setenv("RS_INT8", "1")
    rng = np.random.RandomState(2)
    feats = _nhwc(rng, [(2, 16, 16, 24), (2, 8, 8, 24), (2, 4, 4, 24)])
    kw = dict(in_channels=24, feat_channels=24, anchor_generator=ANCHORS,
              nms_pre=64, nms_post=48, pre_nms_cap=160)
    jm = JRPN(**kw)
    v = _init(jm, 2, _j(feats))
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        v["params"][name]["kernel"] *= 40.0
    port = load_jax_variables(OrientedRPNHead(**kw, int8=True).eval(), v)
    cls_j, reg_j = jax.jit(jm.apply)(v, _j(feats))
    cls_t, reg_t = port(_t(feats))
    cls_f, reg_f = load_jax_variables(OrientedRPNHead(**kw).eval(), v)(
        _t(feats))
    for g, r, f in zip(cls_t + reg_t, cls_j + reg_j, cls_f + reg_f):
        _steps_apart(g.detach().numpy(), r, float(f.abs().max()) / 127)
        assert float((g - f).abs().max()) > 0     # the tower is quantized


def test_int8_backbone_tracks_float_within_the_jax_bounds():
    """The JAX package's own whole-backbone check
    (``test_van_backbone_int8_activation_diff``), for the port in the CUDA
    kernel's scale group and in the JAX groups."""
    cfg = dict(embed_dims=(16, 32, 64, 128), mlp_ratios=(4, 4, 2, 2),
               depths=(1, 1, 1, 1))
    torch.manual_seed(0)
    fp = VAN(**cfg).eval()
    x = torch.from_numpy(
        np.random.RandomState(3).randn(1, 64, 64, 3).astype(np.float32))
    for fused in (False, True):
        q = VAN(**cfg, fused=fused, int8=True).eval()
        q.load_state_dict(fp.state_dict())
        for group in ("tile", "tensor", ("rows", 32)):
            _set_group(q, group)
            with torch.no_grad():
                for r, g in zip(fp(x), q(x)):
                    rel = float((g - r).abs().max() / r.abs().max())
                    assert rel < 0.15, (fused, group, rel)
                    corr = np.corrcoef(r.numpy().ravel(),
                                       g.numpy().ravel())[0, 1]
                    assert corr > 0.995, (fused, group, corr)


def test_int8_flag_is_ignored_in_training():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 32, 16, 16).astype(np.float32))
    torch.manual_seed(1)
    plain = VANBlock(32, 4.0)
    q = VANBlock(32, 4.0, fused=True, int8=True)
    q.load_state_dict(plain.state_dict())
    a, b = q.train()(x), plain.train()(x)
    assert a.grad_fn is not None
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():      # and serving is where it differs
        assert float((q.eval()(x) - plain.eval()(x)).abs().max()) > 0
    feats = _t(_nhwc(rng, [(1, 8, 8, 16), (1, 4, 4, 32)]))
    fa, fb = FPN((16, 32), 16, num_outs=3, int8=True), FPN((16, 32), 16,
                                                           num_outs=3)
    fb.load_state_dict(fa.state_dict())
    for g, r in zip(fa.train()(feats), fb.train()(feats)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    kw = dict(in_channels=16, feat_channels=16, anchor_generator=ANCHORS)
    ra, rb = OrientedRPNHead(**kw, int8=True), OrientedRPNHead(**kw)
    rb.load_state_dict(ra.state_dict())
    level = [torch.from_numpy(rng.randn(1, 8, 8, 16).astype(np.float32))]
    torch.testing.assert_close(ra.train()(level)[0][0],
                               rb.train()(level)[0][0], rtol=0, atol=0)


# --- the slice ---------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_tree():
    model = jax_tiny()
    variables = jax.jit(lambda i: model.init(
        {"params": jax.random.PRNGKey(0)}, i))(
            jnp.zeros((1, 128, 128, 3), jnp.float32))
    return perturb(variables, seed=3)


def test_state_dict_is_the_same_with_int8_on_and_off(flax_tree):
    """One flax tree loads into every mode; the weights are quantized per
    call, so weights loaded after construction are the ones served."""
    off = build_flagship(tiny=True, device="cpu")
    on = build_flagship(tiny=True, device="cpu", int8=True)
    both = build_flagship(tiny=True, device="cpu", fused=True, int8=True)
    shapes = {k: tuple(v.shape) for k, v in off.state_dict().items()}
    for m in (on, both):
        assert {k: tuple(v.shape) for k, v in m.state_dict().items()} \
            == shapes
        assert list(m.state_dict()) == list(off.state_dict())
    images = normalize(torch.from_numpy(np.random.RandomState(11).randint(
        0, 256, (1, 128, 128, 3)).astype(np.uint8)))
    before = on.predict(images)["scores"]
    for m in (off, on, both):
        load_jax_variables(m, flax_tree)
    after = on.predict(images)["scores"]
    assert float((after - before).abs().max()) > 1e-3
    fresh = load_jax_variables(build_flagship(tiny=True, device="cpu",
                                              int8=True), flax_tree)
    torch.testing.assert_close(fresh.predict(images)["scores"], after,
                               rtol=0, atol=0)


def _jax_stages(model, x):
    feats = model.backbone(x, False)
    pyramid = model.neck(feats)
    return feats, pyramid, model.rpn(pyramid)


@pytest.mark.parametrize("fused", [False, True], ids=["non_fused", "fused"])
def test_tiny_int8_predict_matches_jax(flax_tree, fused, monkeypatch):
    """Non-fused, the JAX package on the CPU runs ``_int8_mlp`` (group
    "tensor"); fused (``RS_VAN_FUSED_FORCE``), its Pallas kernels in
    interpret mode, whose MLP takes one row block per image at these
    sizes (group ("rows", 32)).

    What can be compared how closely: an int8 step that the two
    packages' f32 noise sets off moves its neighbourhood by ~1e-3, which
    sets off further steps in the next layer (a perturbation of 1e-3
    flips ~3% of the values it reaches), so after a few blocks the two
    runs carry independent quantization noise and agree only as closely
    as int8 agrees with float. Hence: (1) every int8 stage of the
    flagship against its JAX twin **on the JAX stage's input**, within a
    few steps; (2) the whole backbone within the bound of the JAX
    package's own int8-against-float check, tightened (relative
    difference < 0.05, correlation > 0.999, against 0.15 and 0.995); (3)
    ``predict`` without regard to rank, since that noise reorders the
    near-tied proposals of a random-weight model: the same number of
    valid slots, and per class the sorted scores within 0.05."""
    monkeypatch.setenv("RS_INT8", "1")
    if fused:
        monkeypatch.setenv("RS_VAN_FUSED_FORCE", "1")
    model = jax_tiny()
    port = _set_group(load_jax_variables(build_flagship(
        tiny=True, device="cpu", fused=fused, int8=True), flax_tree),
        ("rows", 32) if fused else "tensor")
    assert port.neck.int8 and port.rpn.int8 and all(
        m.int8 for m in port.backbone.modules() if isinstance(m, Mlp))
    fp = load_jax_variables(build_flagship(tiny=True, device="cpu",
                                           fused=fused), flax_tree)
    tiles = np.random.RandomState(11).randint(
        0, 256, (2, 128, 128, 3)).astype(np.uint8)
    images = normalize(torch.from_numpy(tiles))
    jimages = jnp.asarray(images.numpy())
    jfeats, jpyr, (jcls, jreg) = jax.jit(
        lambda v, i: model.apply(v, i, method=_jax_stages))(flax_tree, jimages)
    with torch.no_grad():
        # (1) stage by stage on the JAX inputs: the first block (the stem
        # ahead of it is float), the neck, the RPN forward
        stem = port.backbone.patch_embed1(images.permute(0, 3, 1, 2))
        jblock = JVANBlock(dim=DIMS[0], mlp_ratio=8).apply(
            {c: t["backbone"]["block1_0"] for c, t in flax_tree.items()},
            jnp.asarray(stem.permute(0, 2, 3, 1).numpy()))
        block = port.backbone.block1_0(stem)
        cls, reg = port.rpn(_t(jpyr))
        for g, r in [(block.permute(0, 2, 3, 1), jblock),
                     *zip(port.neck(_t(jfeats)), jpyr),
                     *zip(cls + reg, jcls + jreg)]:
            _steps_apart(g.numpy(), r,
                         float(np.abs(np.asarray(r)).max()) / 127)
        # (2) the whole backbone
        for g, r in zip(port.backbone(images), jfeats):
            g, r = g.numpy(), np.asarray(r)
            assert np.abs(g - r).max() / np.abs(r).max() < 0.05
            assert np.corrcoef(g.ravel(), r.ravel())[0, 1] > 0.999
    # (3) predict
    got = port.predict(images)
    ref = jax.jit(lambda v, i: model.apply(v, i, method=model.predict))(
        flax_tree, jimages)
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 32
    assert abs(int(got["valid"].sum()) - int(valid.sum())) \
        <= valid.size // 50
    scores = got["scores"].numpy()
    fp_scores = fp.predict(images)["scores"].numpy()
    for other in (np.asarray(ref["scores"]), fp_scores):
        assert np.abs(np.sort(scores, axis=1)
                      - np.sort(other, axis=1)).max() < 0.05
    assert np.abs(scores - fp_scores).max() > 0
