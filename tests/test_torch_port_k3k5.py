"""The redesigned K3 and K5 of the PyTorch port, on the CPU: the plain
version of K3's destination-ordered design (records, a stable sort by
destination, segment sums) against the plain backward and against
``jax.vjp`` of the JAX package's exact RoIAlign; its records; its bits
with the rois in another order; the launch plan of K5's streaming design
(``ops/dwconv.py:dw_plan``) at VAN-b3's shapes and what it sends to the
first design; how many channels a lane of K3 takes; and the new wrapper
paths refusing what they cannot take before the kernel library is
built."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.ops.roi_align import roi_align_rotated_pyramid as jroi
from rs_detection_tpu_torch.ops import dwconv, roi_align
from rs_detection_tpu_torch.ops.dwconv import H100_SMEM, dw_plan
from rs_detection_tpu_torch.ops.roi_align import (
    _bwd_records, k3_vec, roi_align_rotated_pyramid_bwd_reference,
    roi_align_rotated_pyramid_bwd_sorted_reference)
from torch_one_thread import _one_thread  # noqa: F401

STRIDES = (4, 8, 16, 32)
# (H = W, C) of VAN-b3's four attention stages at 1024^2 tiles
STAGES = [(256, 64), (128, 128), (64, 320), (32, 512)]
t = torch.from_numpy


def _pyramid(rng, n=2, c=8, base=64):
    return [rng.randn(n, base // (s // 4), base // (s // 4), c)
            .astype(np.float32) for s in STRIDES]


def _rois(rng, r, n, img=256.0):
    """Rois on every level; centres up to 25% past each border, so some
    samples clamp at the last row or column and some fall outside."""
    scale = np.exp(rng.uniform(np.log(10), np.log(600), r))
    aspect = np.exp(rng.uniform(-1.5, 1.5, r))
    rois = np.stack([rng.randint(0, n, r), rng.uniform(-0.25, 1.25, r) * img,
                     rng.uniform(-0.25, 1.25, r) * img, scale * aspect,
                     scale / aspect, rng.uniform(-np.pi, np.pi, r)], 1)
    rois[:4, 1:3] = [[img - 1.0, img - 1.0], [-2.0, 100.0], [300.0, 300.0],
                     [0.0, img]]          # on and past the borders
    return rois.astype(np.float32)


def _max_rel(got, ref):
    scale = max(np.abs(np.asarray(r)).max() for r in ref)
    return max(np.abs(g.numpy() - np.asarray(r)).max()
               for g, r in zip(got, ref)) / scale


def test_sorted_backward_matches_plain_backward_and_jax_vjp():
    rng = np.random.RandomState(41)
    feats, rois = _pyramid(rng), _rois(rng, 200, 2)
    g = rng.randn(200, 7, 7, 8).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jroi(f, jnp.asarray(rois), 7,
                                    strides=STRIDES),
                     [jnp.asarray(f) for f in feats])
    (ref,) = vjp(jnp.asarray(g))
    got = roi_align_rotated_pyramid_bwd_sorted_reference(
        [t(f) for f in feats], t(rois), t(g))
    torch.use_deterministic_algorithms(True)
    try:
        plain = roi_align_rotated_pyramid_bwd_reference(
            [t(f) for f in feats], t(rois), t(g))
    finally:
        torch.use_deterministic_algorithms(False)
    assert [tuple(x.shape) for x in got] == [f.shape for f in feats]
    assert _max_rel(got, ref) <= 1e-5
    assert _max_rel(got, plain) <= 1e-5
    assert all(np.abs(np.asarray(r)).max() > 0 for r in ref)


def test_sorted_backward_gives_the_same_bits_with_the_rois_shuffled():
    """Two runs on the rois in a shuffled order (g shuffled with them)
    give the same bits: the stable sort fixes the order of every sum.
    Against the unshuffled order the sums are only reordered."""
    rng = np.random.RandomState(42)
    feats, rois = _pyramid(rng), _rois(rng, 150, 2)
    g = rng.randn(150, 7, 7, 8).astype(np.float32)
    perm = rng.permutation(150)
    args = ([t(f) for f in feats], t(rois[perm]), t(g[perm]))
    one = roi_align_rotated_pyramid_bwd_sorted_reference(*args)
    two = roi_align_rotated_pyramid_bwd_sorted_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    base = roi_align_rotated_pyramid_bwd_sorted_reference(
        [t(f) for f in feats], t(rois), t(g))
    assert _max_rel(one, [b.numpy() for b in base]) <= 1e-6


def test_bwd_records_are_four_corners_of_every_live_sample():
    """Records in (roi, bin, sample, corner) order: a live sample has 4
    records whose weights sum to 1 / S^2 and whose destinations lie on
    the roi's level and image; a dead one has 4 with the pixel count as
    destination and weight 0."""
    rng = np.random.RandomState(43)
    feats = [t(f) for f in _pyramid(rng)]
    rois = t(_rois(rng, 60, 2))
    keys, wts, total = _bwd_records(feats, rois, 7, STRIDES, 2, 56.0)
    assert total == sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats)
    keys, wts = keys.reshape(60, 49 * 4, 4), wts.reshape(60, 49 * 4, 4)
    dead = keys == total
    assert torch.equal(dead.all(-1), dead.any(-1))      # whole samples
    assert 0 < dead.all(-1).float().mean() < 1
    assert (wts[dead] == 0).all()
    live = ~dead.all(-1)
    torch.testing.assert_close(wts.sum(-1)[live],
                               torch.full_like(wts.sum(-1)[live], 0.25))
    offsets = np.cumsum([0] + [f.shape[0] * f.shape[1] * f.shape[2]
                               for f in feats])
    lvl = roi_align.map_roi_levels(rois[:, 3], rois[:, 4], 4)
    for r in range(60):
        k = keys[r][live[r]]
        lo = offsets[lvl[r]] + int(rois[r, 0]) * feats[lvl[r]].shape[1] \
            * feats[lvl[r]].shape[2]
        hi = lo + feats[lvl[r]].shape[1] * feats[lvl[r]].shape[2]
        assert ((k >= lo) & (k < hi)).all()


@pytest.mark.parametrize("k,d", [(5, 1), (7, 3)])
@pytest.mark.parametrize("h,c", STAGES)
def test_dw_plan_of_each_attention_shape_streams(k, d, h, c):
    plan = dw_plan(k, d, h, h, c, torch.bfloat16, n=8)
    assert plan["design"] == "stream"
    assert plan["stages"] >= 2 and plan["ring_rows"] == 4 * plan["stages"] \
        + k - 1
    assert 0 < plan["smem"] <= H100_SMEM
    assert plan["blocks_per_sm"] >= 1
    assert plan["blocks_per_sm"] * (plan["smem"] + 1024) <= 233472
    assert plan["groups"] % d == 0 and plan["tw"] == 4 * plan["groups"]
    assert plan["strips"] * plan["tw"] >= h > (plan["strips"] - 1) \
        * plan["tw"]
    # the segments cover every row of the largest row class, none empty
    rows = -(-h // d)
    assert plan["segs"] * plan["seg_steps"] * 4 >= rows \
        > (plan["segs"] - 1) * plan["seg_steps"] * 4
    assert plan["blocks"] == 8 * -(-c // 64) * plan["strips"] * d \
        * plan["segs"]


@pytest.mark.parametrize("k,d,c,dtype,hcw,aligned", [
    (3, 1, 512, torch.bfloat16, False, True),     # the MLP's dw3
    (7, 3, 64, torch.float32, False, True),
    (7, 3, 64, torch.float32, True, True),        # K7's layout in f32
    (5, 1, 36, torch.bfloat16, False, True),      # C not a multiple of 8
    (5, 1, 64, torch.bfloat16, False, False),     # x not 16-byte aligned
    (5, 2, 64, torch.bfloat16, False, True),      # no build for (5, 2)
    (7, 1, 64, torch.bfloat16, False, True)])
def test_dw_plan_sends_the_rest_to_the_first_design(k, d, c, dtype, hcw,
                                                    aligned):
    plan = dw_plan(k, d, 64, 64, c, dtype, n=2, hcw=hcw, aligned=aligned)
    assert plan["design"] == "first"
    assert plan["rows"] == (1 if k == 3 else 4)
    assert 0 < plan["smem"] <= H100_SMEM


def test_dw_plan_refuses_what_no_design_takes():
    with pytest.raises(ValueError):
        dw_plan(4, 1, 64, 64, 64, torch.bfloat16)
    with pytest.raises(ValueError):
        dw_plan(5, 0, 64, 64, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        dw_plan(5, 1, 64, 64, 64, torch.float16)
    with pytest.raises(ValueError):          # the first design's tile
        dw_plan(7, 30, 64, 64, 64, torch.float32)
    # a smaller card: the streaming blocks no longer fit, the first does
    small = dw_plan(7, 3, 64, 64, 64, torch.bfloat16, smem_limit=70 * 1024)
    assert small["design"] == "first"


@pytest.mark.parametrize("c,dtype,aligned,vec", [
    (256, torch.bfloat16, True, 8), (32, torch.float32, True, 4),
    (8, torch.bfloat16, True, 8), (30, torch.float32, True, 1),
    (36, torch.bfloat16, True, 1), (256, torch.bfloat16, False, 1)])
def test_k3_vec_by_shape_and_dtype(c, dtype, aligned, vec):
    """One 16-byte vector per lane where C and the alignment allow it,
    else one channel: K3's one design takes every width."""
    assert k3_vec(c, dtype, aligned) == vec


def test_k3_vec_refuses_other_dtypes():
    with pytest.raises(TypeError):
        k3_vec(256, torch.float16)


def test_new_wrapper_paths_refuse_before_the_library_is_built(monkeypatch):
    def no_build():
        raise AssertionError("the kernel library must not be built here")

    monkeypatch.setattr(roi_align, "kernel_library", no_build)
    monkeypatch.setattr(dwconv, "kernel_library", no_build)
    feats = [torch.zeros(1, s, s, 256) for s in (16, 8, 4, 2)]
    rois = torch.zeros(3, 6)
    grad = torch.zeros(3, 7, 7, 256)
    for fn in (roi_align.roi_align_rotated_pyramid_bwd_cuda,
               roi_align.roi_align_rotated_pyramid_bwd_first_design):
        with pytest.raises(ValueError):      # CPU tensors
            fn(feats, rois, grad)
        with pytest.raises(TypeError):       # a dtype no kernel takes
            fn([f.half() for f in feats], rois, grad.half())
    x = torch.zeros(1, 8, 8, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 25, dtype=torch.bfloat16)
    for fn in (dwconv.depthwise_conv2d_cuda,
               dwconv.depthwise_conv2d_first_design):
        with pytest.raises(ValueError):      # CPU tensors
            fn(x, w, 5, 1, taps_last=True)
    with pytest.raises(TypeError):
        dwconv.depthwise_conv2d_cuda(x.half(), w.half(), 5, 1,
                                     taps_last=True)
