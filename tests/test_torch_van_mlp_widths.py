"""The VAN MLP at every width the registered VAN and LSKNet variants have,
on the CPU: the launch plans of ``ops/van_mlp.py:kernel_plan`` (float
and int8 forms, f32 and bf16; the residual flag runs the same launch)
fit one block's shared memory on an H100 at every stage of every
variant, read from the port's ``BACKBONES`` registry so that a new
variant is covered; the f32 design fits at any width up to 1024; and the
plain versions beside the kernels match the JAX package at the wide
stages (``_ref_mlp``, the Pallas kernel in interpret mode and
``_int8_mlp``). ``tests/test_torch_port_cuda.py`` holds the plans
against the built library and the kernels against these plain versions
on a GPU."""

import numpy as np
import pytest
import torch

from rs_detection_tpu.ops.pallas_van_mlp import _int8_mlp, _ref_mlp
from rs_detection_tpu.ops.pallas_van_mlp import van_mlp as jvan_mlp
from rs_detection_tpu_torch.models import backbones  # noqa: F401
from rs_detection_tpu_torch.models.backbones.van import Mlp
from rs_detection_tpu_torch.ops.van_mlp import (BF16_WIDTHS, H100_SMEM,
                                                f32_slots, kernel_plan,
                                                van_mlp_int8_reference,
                                                van_mlp_reference)
from rs_detection_tpu_torch.utils.registry import BACKBONES
from test_torch_port_int8 import _steps_apart
from test_torch_port_kernels import _jax_layout, _mlp_inputs
from torch_one_thread import _one_thread  # noqa: F401

VARIANTS = sorted(name for name in BACKBONES.modules
                  if name.lower().startswith(("van", "lsknet")))


def _mlp_widths(name):
    """(C, Ch) of every MLP of the registered backbone ``name``, in stage
    order, built on the meta device (no weights are allocated)."""
    with torch.device("meta"):
        model = BACKBONES.get(name)()
    widths = []
    for m in model.modules():
        if isinstance(m, Mlp):
            ch, c = m.fc1.weight.shape[:2]
            if (c, ch) not in widths:
                widths.append((c, ch))
    return widths


def test_the_registry_holds_the_van_and_lsknet_variants():
    assert {"VAN", "van_b0", "van_b1", "van_b2", "van_b3", "LSKNet",
            "lsknet_t", "lsknet_s"} <= set(VARIANTS)
    assert _mlp_widths("van_b0") == [(32, 256), (64, 512), (160, 640),
                                     (256, 1024)]
    assert _mlp_widths("van_b3") == [(64, 512), (128, 1024), (320, 1280),
                                     (512, 2048)]


@pytest.mark.parametrize("name", VARIANTS)
def test_every_stage_of_every_variant_fits_one_block(name):
    """Every stage, both dtypes, float and int8 (with and without the
    residual: one launch plan) fits 232,448 B; bf16 takes each width."""
    widths = _mlp_widths(name)
    assert len(widths) >= 4, widths
    for c, ch in widths:
        assert c in BF16_WIDTHS, (name, c)
        for dtype in (torch.float32, torch.bfloat16):
            for int8 in (False, True):
                plan = kernel_plan(c, ch, dtype, int8=int8)
                assert 0 < plan["smem"] <= H100_SMEM, (name, c, ch, dtype,
                                                       int8, plan)
                if dtype == torch.float32:
                    assert plan["design"] == "fma"
                    assert plan["splits"] == 1 and 32 * plan["slots"] >= c


def test_f32_design_fits_every_width_up_to_1024():
    """One block's shared memory no longer grows with C: 69,632 + 9,216 J
    bytes in the float form (J <= 16 output channels a thread), and the
    int8 form keeps one staging buffer where two do not fit."""
    for c in range(1, 1025):
        j, splits = f32_slots(c)
        assert 32 * j * splits >= c and j <= 16
        assert splits == -(-c // 512)
        for int8 in (False, True):
            plan = kernel_plan(c, 4 * c, torch.float32, int8=int8)
            assert plan["design"] == "fma" and plan["smem"] <= H100_SMEM, c
        assert kernel_plan(c, 4 * c, torch.float32)["smem"] == \
            69632 + 9216 * j


@pytest.mark.parametrize("c,want", [(32, (1, 1)), (64, (2, 1)),
                                    (128, (4, 1)), (160, (5, 1)),
                                    (256, (8, 1)), (320, (10, 1)),
                                    (512, (16, 1)), (600, (10, 2)),
                                    (1024, (16, 2)), (1025, (16, 3))])
def test_f32_slots_split_wide_c_into_equal_parts(c, want):
    assert f32_slots(c) == want


WIDE = [(160, 640), (320, 1280), (512, 2048)]


@pytest.mark.parametrize("jax_fn", [_ref_mlp, jvan_mlp],
                         ids=["ref_mlp", "pallas_interpret"])
@pytest.mark.parametrize("c,ch", WIDE)
def test_van_mlp_reference_matches_jax_at_wide_stages(c, ch, jax_fn):
    args = _mlp_inputs(c + ch, n=1, h=3, w=5, c=c, ch=ch)
    got = van_mlp_reference(*(torch.from_numpy(a) for a in args))
    ref = np.asarray(jax_fn(*_jax_layout(*args)))
    # f32 on both sides: summation order and the JAX GELU's 1.5e-7 erf
    # polynomial; outputs are O(1)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("c,ch", WIDE)
def test_int8_reference_matches_jax_int8_mlp_at_wide_stages(c, ch):
    args = _mlp_inputs(c + ch + 1, n=1, h=3, w=5, c=c, ch=ch)
    tensors = [torch.from_numpy(a) for a in args]
    ref = np.asarray(_int8_mlp(*_jax_layout(*args)))
    got = van_mlp_int8_reference(*tensors, group="tensor")
    fp = van_mlp_reference(*tensors)
    # the same quantizers with f32 noise between them: the hidden
    # tensor's step bounds a flipped value
    _steps_apart(got.numpy(), ref, float(fp.abs().max()) / 127)
    assert 1e-3 < float((got - fp).abs().max() / fp.abs().max()) < 0.05
