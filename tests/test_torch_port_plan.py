"""The launch plans that the port keeps in Python, on the CPU: which
design of the VAN MLP kernel (float and int8) a shape picks and what it
asks of the card (``ops/van_mlp.py:kernel_plan``), the same for the two
pointwise stages of the attention half-block
(``ops/van_attn.py:attn_plan``), how a depthwise weight gradient is cut
into blocks (``ops/dw_conv.py:wgrad_plan``), and the Python version of
the int8 kernel's weight packing. All mirror the launchers in ``csrc/``; ``tests/test_torch_port_cuda.py`` holds the
mirrors against the built library on a GPU. Also: a wrapper refuses what
no kernel takes before it builds or loads anything."""

import pytest
import torch

from rs_detection_tpu_torch.ops import dw_conv, van_attn, van_mlp
from rs_detection_tpu_torch.ops.dw_conv import (H100_SMEM, H100_SMS, _parts,
                                                wgrad_plan)
from rs_detection_tpu_torch.ops.quant import qweight
from rs_detection_tpu_torch.ops.van_attn import attn_plan
from rs_detection_tpu_torch.ops.van_mlp import (kernel_plan,
                                                pack_int8_weights,
                                                unpack_int8_weights)

# (H = W, C, Ch) of VAN-b3's four stages at 1024^2 tiles, batch 8
STAGES = [(256, 64, 512), (128, 128, 1024), (64, 320, 1280), (32, 512, 2048)]
BATCH = 8


def _strides(shape, channels_last):
    n, c, h, w = shape
    return (h * w * c, 1, w * c, c) if channels_last else (c * h * w, h * w,
                                                           w, 1)


@pytest.mark.parametrize("h,c,ch", STAGES)
def test_mlp_plan_of_each_stage_fits_one_block(h, c, ch):
    plan = kernel_plan(c, ch, torch.bfloat16)
    assert plan["design"] == "wgmma"
    assert plan["chunk"] == (32 if c == 512 else 64)
    assert 0 < plan["smem"] <= H100_SMEM
    # the packed weights: w1, w2 and 11 values per hidden channel, in bf16
    assert plan["scratch"] == 2 * (2 * c * ch + 11 * ch)
    # the narrow stages leave room for two blocks on an SM
    assert (2 * (plan["smem"] + 1024) <= H100_SMEM) == (c <= 128)


@pytest.mark.parametrize("c,ch,dtype,design", [
    (64, 96, torch.bfloat16, "wgmma"),     # Ch no multiple of the chunk
    (320, 200, torch.bfloat16, "wgmma"),
    (64, 100, torch.bfloat16, "wmma"),     # Ch no multiple of 8
    (32, 96, torch.bfloat16, "wmma"),      # narrower than a swizzled row
    (32, 96, torch.float32, "fma"),
    (20, 40, torch.float32, "fma"),
    (320, 1280, torch.float32, "fma")])
def test_mlp_plan_picks_the_design_by_shape(c, ch, dtype, design):
    plan = kernel_plan(c, ch, dtype)
    assert plan["design"] == design
    assert (plan["scratch"] > 0) == (design == "wgmma")
    if design != "wgmma":
        assert plan["chunk"] == van_mlp.CHUNK
    # a partial last chunk is packed whole (zero past Ch)
    if design == "wgmma":
        chunks = -(-ch // plan["chunk"])
        assert plan["scratch"] == chunks * plan["chunk"] * 2 * (2 * c + 11)


def test_mlp_plan_drops_to_one_staging_buffer_where_two_do_not_fit():
    two = kernel_plan(320, 100, torch.bfloat16)["smem"]
    one = kernel_plan(512, 100, torch.bfloat16)["smem"]
    assert two <= H100_SMEM and one <= H100_SMEM
    # on a device with less shared memory the same shape keeps one buffer
    assert kernel_plan(320, 100, torch.bfloat16, smem_limit=two - 1)["smem"] \
        < two


@pytest.mark.parametrize("c,ch,dtype", [(48, 96, torch.bfloat16),
                                        (0, 8, torch.float32),
                                        (64, 0, torch.bfloat16)])
def test_mlp_plan_refuses_widths_no_kernel_takes(c, ch, dtype):
    with pytest.raises(ValueError):
        kernel_plan(c, ch, dtype)


def test_wrappers_refuse_before_the_library_is_built(monkeypatch):
    def no_build():
        raise AssertionError("the kernel library must not be built here")

    monkeypatch.setattr(van_mlp, "kernel_library", no_build)
    monkeypatch.setattr(dw_conv, "kernel_library", no_build)
    x = torch.zeros(1, 8, 8, 64)
    args = (x, torch.zeros(64, 64), torch.zeros(64), torch.zeros(64, 9),
            torch.zeros(64), torch.zeros(64, 64), torch.zeros(64))
    for fn in (van_mlp.van_mlp_cuda, van_mlp.van_mlp_residual_cuda,
               van_mlp.van_mlp_int8_cuda):
        with pytest.raises(ValueError):      # CPU tensors
            fn(*args)
        with pytest.raises(TypeError):       # a dtype no kernel takes
            fn(*(a.half() for a in args))
    g = torch.zeros(1, 4, 8, 8)
    with pytest.raises(ValueError):
        dw_conv.dw_wgrad_cuda(g, g, 3)       # CPU tensors
    with pytest.raises(ValueError):
        dw_conv.dw_wgrad_cuda(g, g, 4)       # k
    with pytest.raises(TypeError):
        dw_conv.dw_wgrad_cuda(g.half(), g.half(), 3)


# the twelve depthwise convs of a VAN-b3 step: dw3 on the MLP's hidden
# tensor and dw5 in channels_last, the dilated 7x7 in NCHW
DW_SHAPES = [(3, 1, h, ch, True) for h, _, ch in STAGES] \
    + [(5, 1, h, c, True) for h, c, _ in STAGES] \
    + [(7, 3, h, c, False) for h, c, _ in STAGES]


@pytest.mark.parametrize("k,d,h,c,channels_last", DW_SHAPES)
def test_wgrad_plan_of_each_flagship_shape(k, d, h, c, channels_last):
    shape = (BATCH, c, h, h)
    st = _strides(shape, channels_last)
    plan = wgrad_plan(shape, st, st, k, d, 2)
    assert plan["design"] == ("nhwc" if channels_last else "nchw")
    assert 0 < plan["smem"] <= H100_SMEM
    assert 1 <= plan["parts"] <= min(plan["items"], 512)
    blocks = plan["ctiles"] * plan["parts"]
    slots = 2 * H100_SMS
    # no wave of blocks is wasted: one more part would not be cheaper
    cost = -(-blocks // slots) * -(-plan["items"] // plan["parts"])
    assert cost <= -(-plan["ctiles"] // slots) * plan["items"]
    # the partial sums stay small: [parts, k*k, C] f32
    assert plan["parts"] * k * k * c * 4 <= 16 << 20


@pytest.mark.parametrize("k,d,itemsize", [(3, 1, 2), (5, 1, 2), (7, 3, 2),
                                          (3, 1, 4), (5, 1, 4), (7, 3, 4)])
def test_wgrad_nhwc_tile_fits_for_every_kernel_size(k, d, itemsize):
    tw, smem = dw_conv._nhwc_tile(k, d, itemsize)
    assert tw in (8, 16) and smem <= H100_SMEM
    # the block reduction's scratch ([8 warps, k*k, 64] f32) fits too
    assert smem >= 8 * k * k * 64 * 4


def test_wgrad_plan_falls_back_to_the_first_design():
    shape = (2, 40, 37, 45)
    nchw, nhwc = _strides(shape, False), _strides(shape, True)
    assert wgrad_plan(shape, nchw, nchw, 7, 3, 4)["design"] == "nchw"
    assert wgrad_plan(shape, nhwc, nhwc, 7, 3, 4)["design"] == "nhwc"
    # another (k, dilation) than VAN's, or x and g in two formats
    assert wgrad_plan(shape, nhwc, nhwc, 3, 2, 4)["design"] == "generic"
    assert wgrad_plan(shape, nchw, nchw, 7, 1, 4)["design"] == "generic"
    assert wgrad_plan(shape, nhwc, nchw, 3, 1, 4)["design"] == "generic"
    plan = wgrad_plan(shape, nhwc, nchw, 3, 1, 4)
    assert plan["ctiles"] == 2 and plan["items"] == 2 * 3 * 3
    # rows too wide for two bands in shared memory
    wide = (1, 4, 8, 20000)
    st = _strides(wide, False)
    assert wgrad_plan(wide, st, st, 7, 3, 4)["design"] == "generic"


@pytest.mark.parametrize("ctiles,items,slots,want", [
    (20, 256, 264, 13),    # one wave of 260 blocks, 20 tiles each
    (1, 4096, 264, 256),   # 16 tiles each; 264 parts would also take 16
    (320, 8, 264, 4),      # five waves of four-band blocks beat two of 8
    (512, 8, 264, 1),
    (1, 1, 264, 1),
    (1, 3, 264, 3)])
def test_wgrad_parts(ctiles, items, slots, want):
    assert _parts(ctiles, items, slots) == want


def test_wgrad_band_rows_keep_two_buffers_under_96_kib():
    for h, w in ((256, 256), (128, 128), (64, 64), (32, 32), (37, 45),
                 (512, 1024), (3, 3)):
        th = dw_conv._nchw_band(18, h, w, 2)
        assert 1 <= th <= h
        assert th == 1 or dw_conv._nchw_smem(th, 18, w, 2) <= 96 * 1024


@pytest.mark.parametrize("h,c,ch", STAGES)
def test_int8_mlp_plan_of_each_stage_fits_one_block(h, c, ch):
    plan = kernel_plan(c, ch, torch.bfloat16, int8=True)
    assert plan["design"] == "wgmma"
    # a round is two 32-channel scale chunks, one at C = 512
    assert plan["chunk"] == (32 if c == 512 else 64)
    assert plan["chunk"] % van_mlp.CHUNK == 0
    assert 0 < plan["smem"] <= H100_SMEM
    # the packed weights: w1 and w2 in s8, per hidden channel b1, bdw and
    # nine taps in bf16 and sw1 in f32, and sw2 in f32
    assert plan["scratch"] == 2 * c * ch + 26 * ch + 4 * c
    # s8 halves the patch and the weights: less than the float design
    assert plan["smem"] < kernel_plan(c, ch, torch.bfloat16)["smem"]
    # the narrow stages leave room for two blocks on an SM
    assert (2 * (plan["smem"] + 1024) <= H100_SMEM) == (c <= 128)


@pytest.mark.parametrize("c,ch,dtype,design", [
    (64, 96, torch.bfloat16, "wgmma"),     # Ch no multiple of the round
    (320, 200, torch.bfloat16, "wgmma"),
    (64, 100, torch.bfloat16, "wgmma"),    # Ch no multiple of 8: any Ch
    (256, 72, torch.bfloat16, "wgmma"),
    (32, 96, torch.bfloat16, "wmma"),      # narrower than a swizzled row
    (32, 96, torch.float32, "fma"),
    (20, 40, torch.float32, "fma"),
    (320, 1280, torch.float32, "fma")])
def test_int8_mlp_plan_picks_the_design_by_shape(c, ch, dtype, design):
    plan = kernel_plan(c, ch, dtype, int8=True)
    assert plan["design"] == design
    assert 0 < plan["smem"] <= H100_SMEM
    if design == "wgmma":  # a partial last round is packed whole
        rounds = -(-ch // plan["chunk"])
        assert plan["scratch"] == rounds * plan["chunk"] * (2 * c + 26) + 4 * c
    else:  # the quantized rows, 16-byte aligned, and the scales
        assert plan["chunk"] == van_mlp.CHUNK
        assert plan["scratch"] >= 2 * c * ch + 4 * (c + ch)
        assert plan["scratch"] < 2 * c * ch + 4 * (c + ch) + 48


@pytest.mark.parametrize("c,ch,dtype", [(48, 96, torch.bfloat16),
                                        (96, 96, torch.bfloat16),
                                        (0, 8, torch.float32),
                                        (64, 0, torch.bfloat16)])
def test_int8_mlp_plan_refuses_widths_no_kernel_takes(c, ch, dtype):
    with pytest.raises(ValueError):
        kernel_plan(c, ch, dtype, int8=True)


@pytest.mark.parametrize("c,ch", [(64, 512), (128, 256), (256, 72),
                                  (320, 200), (512, 2048), (64, 100),
                                  (512, 40)])
def test_int8_weight_packing_round_trip(c, ch):
    g = torch.Generator().manual_seed(c + ch)

    def r(*s):
        return torch.randn(*s, generator=g).to(torch.bfloat16)

    w1, b1, wdw, bdw, w2 = r(ch, c), r(ch), r(ch, 9), r(ch), r(c, ch)
    w1[3] = 0   # an all-zero row takes scale 1
    buf = pack_int8_weights(w1, b1, wdw, bdw, w2)
    assert buf.dtype == torch.uint8
    assert buf.numel() == kernel_plan(c, ch, torch.bfloat16,
                                      int8=True)["scratch"]
    w1q, sw1, w2q, sw2 = unpack_int8_weights(buf, c, ch)
    (q1, s1), (q2, s2) = qweight(w1, 0), qweight(w2, 0)
    assert torch.equal(w1q, q1) and torch.equal(sw1, s1)
    assert torch.equal(w2q, q2) and torch.equal(sw2, s2)
    assert sw1[3] == 1 and not w1q[3].any()
    # b1, bdw and the taps ride along as bf16, after each round's w1
    kc = van_mlp.int8_round(c)
    vs, _, total = van_mlp._int8_packed(c)
    h = ch - 1
    at = (h // kc) * total + vs
    assert torch.equal(buf[at + 2 * (h % kc):at + 2 * (h % kc) + 2]
                       .view(torch.bfloat16), b1[h:h + 1])
    taps = at + 4 * kc + 18 * (h % kc)
    assert torch.equal(buf[taps:taps + 18].view(torch.bfloat16), wdw[h])


@pytest.mark.parametrize("c", [64, 320, 512])
def test_int8_weight_packing_is_the_swizzled_layout(c):
    """No two weight bytes share a place, a 16-byte vector stays whole,
    and row r of a tile keeps its vector j at j ^ (r // 2) % 4 (rows of 64
    bytes) or j ^ (r // 4) % 2 (rows of 32 bytes, w2 at C = 512)."""
    ch = 3 * van_mlp.int8_round(c) - 8
    at1, at2 = van_mlp._int8_pack_offsets(c, ch, "cpu")
    both = torch.cat([at1.reshape(-1), at2.reshape(-1)])
    assert both.unique().numel() == both.numel()
    for at in (at1, at2):  # 16 consecutive values, 16 consecutive bytes
        v = at.reshape(at.shape[0], -1, 16)
        assert (v[..., 0] % 16 == 0).all()
        assert (v - v[..., :1] == torch.arange(16)).all()
    kc = van_mlp.int8_round(c)
    r = torch.arange(kc)
    assert torch.equal((at1[:kc, 0] - r * 64) // 16, (r // 2) % 4)
    o = torch.arange(c)
    start = at2[:, 0] - van_mlp._int8_packed(c)[1] - o * kc
    assert torch.equal(start // 16, (o // 2) % 4 if kc == 64 else (o // 4) % 2)


def test_int8_weight_packing_refuses_other_widths():
    z = torch.zeros
    with pytest.raises(ValueError):
        pack_int8_weights(z(96, 32).bfloat16(), z(96).bfloat16(),
                          z(96, 9).bfloat16(), z(96).bfloat16(),
                          z(32, 96).bfloat16())
    with pytest.raises(ValueError):
        pack_int8_weights(z(96, 64), z(96), z(96, 9), z(96), z(64, 96))


@pytest.mark.parametrize("h,c,ch", STAGES)
def test_attn_plan_of_each_stage_fits_one_block(h, c, ch):
    plan = attn_plan(c, torch.bfloat16)
    assert plan["design"] == "wgmma"
    assert all(0 < v <= H100_SMEM for v in plan["smem"].values())
    # three C x C weights in bf16, repacked
    assert plan["scratch"] == 3 * c * c * 2
    assert all(c % ns == 0 for ns in plan["slab"].values())
    # 128 pixels a block; tail's two activation tiles leave room for 64 at
    # C = 512
    assert plan["pixels"] == {"proj1": 128, "tail": 64 if c == 512 else 128}
    pixels = BATCH * h * h
    assert pixels % plan["pixels"]["tail"] == 0


@pytest.mark.parametrize("c,dtype,design", [
    (256, torch.bfloat16, "wgmma"),
    (32, torch.bfloat16, "wmma"),      # narrower than a swizzled row
    (96, torch.bfloat16, "wmma"),      # not one of VAN's widths
    (160, torch.bfloat16, "wmma"),
    (64, torch.float32, "fma"),
    (40, torch.float32, "fma"),
    (320, torch.float32, "fma")])
def test_attn_plan_picks_the_design_by_shape(c, dtype, design):
    plan = attn_plan(c, dtype)
    assert plan["design"] == design
    assert (plan["scratch"] > 0) == (design == "wgmma")
    assert all(0 < v <= H100_SMEM for v in plan["smem"].values())
    if design != "wgmma":
        assert plan["pixels"]["tail"] == (64 if dtype == torch.bfloat16
                                          else 32)


def test_attn_plan_keeps_one_staging_buffer_where_that_fits_more_blocks():
    # two buffers on a tie, one where it lets another block onto the SM
    def tail(c, nbuf):
        return 2 * van_attn._up128(64 * (c + 8) * 2) \
            + nbuf * van_attn._up128(32 * (c + 8) * 2) + 8 * 256 * 4
    for c in (32, 96, 160, 224, 384):
        got = attn_plan(c, torch.bfloat16)["smem"]["tail"]
        assert got in (tail(c, 1), tail(c, 2))
        per_sm = van_attn.H100_SMEM_PER_SM
        if got == tail(c, 1):
            assert per_sm // (tail(c, 1) + 1024) > per_sm // (tail(c, 2)
                                                              + 1024)


@pytest.mark.parametrize("c,dtype", [(48, torch.bfloat16),
                                     (0, torch.float32),
                                     (64, torch.float16)])
def test_attn_plan_refuses_widths_no_kernel_takes(c, dtype):
    with pytest.raises(ValueError):
        attn_plan(c, dtype)


def test_attn_wrapper_refuses_before_the_library_is_built(monkeypatch):
    def no_build():
        raise AssertionError("the kernel library must not be built here")

    monkeypatch.setattr(van_attn, "kernel_library", no_build)
    c = 64
    z = torch.zeros
    args = (z(1, 4, 4, c), z(c), z(c), z(c, c, 1, 1), z(c), z(c, 1, 5, 5),
            z(c), z(c, 1, 7, 7), z(c), z(c, c, 1, 1), z(c), z(c, c, 1, 1),
            z(c), z(c))
    with pytest.raises(ValueError):          # CPU tensors
        van_attn.van_attn_cuda(*args)
    with pytest.raises(TypeError):           # a dtype no kernel takes
        van_attn.van_attn_cuda(*(a.half() for a in args))
