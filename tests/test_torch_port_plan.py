"""The launch plans that the port keeps in Python, on the CPU: which
design of the VAN MLP kernel a shape picks and what it asks of the card
(``ops/van_mlp.py:kernel_plan``), and how a depthwise weight gradient is
cut into blocks (``ops/dw_conv.py:wgrad_plan``). Both mirror the
launchers in ``csrc/``; ``tests/test_torch_port_cuda.py`` holds the
mirrors against the built library on a GPU. Also: a wrapper refuses what
no kernel takes before it builds or loads anything."""

import pytest
import torch

from rs_detection_tpu_torch.ops import dw_conv, van_mlp
from rs_detection_tpu_torch.ops.dw_conv import (H100_SMEM, H100_SMS, _parts,
                                                wgrad_plan)
from rs_detection_tpu_torch.ops.van_mlp import kernel_plan

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
