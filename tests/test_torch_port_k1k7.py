"""The redesigned K1 and K7's form of the PyTorch port, on the CPU: the
launch plans of K1's row design (``ops/roi_align.py:k1_plan``) and of the
``[N, H, C, W]`` row-streaming design (``ops/dwconv.py:dw_plan`` with
``hcw``) at the flagship and prototype shapes and what they send to the
first designs; the plain versions of both designs (K1's corner tables
and their sums, the streaming design's ring of output rows over row
classes and segments) against the plain versions, against
``_corners``, and against the JAX package's exact RoIAlign and the
Pallas prototype of ``dw_chw`` (interpret mode); and the new wrapper
paths refusing what they cannot take before the kernel library is
built."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.ops.roi_align import roi_align_rotated_pyramid as jroi
from rs_detection_tpu_torch.ops import dwconv, roi_align
from rs_detection_tpu_torch.ops.dwconv import (CHW_WARPS_PER_SM, dw_chw,
                                               dw_chw_reference,
                                               dw_chw_stream_reference,
                                               dw_plan)
from rs_detection_tpu_torch.ops.roi_align import (
    _corners, k1_bucket_count, k1_buckets, k1_plan, k1_row_tables,
    map_roi_levels,
    roi_align_rotated_pyramid_reference,
    roi_align_rotated_pyramid_rows_reference)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRIDES = (4, 8, 16, 32)
t = torch.from_numpy


def _pyramid(rng, n=2, c=8, base=64):
    return [rng.randn(n, base // (s // 4), base // (s // 4), c)
            .astype(np.float32) for s in STRIDES]


def _rois(rng, r, n, img=256.0):
    """Rois on every level, from a few pixels (samples closer than a
    pixel) to past the image; centres up to 25% past each border."""
    scale = np.exp(rng.uniform(np.log(6), np.log(600), r))
    aspect = np.exp(rng.uniform(-1.5, 1.5, r))
    rois = np.stack([rng.randint(0, n, r), rng.uniform(-0.25, 1.25, r) * img,
                     rng.uniform(-0.25, 1.25, r) * img, scale * aspect,
                     scale / aspect, rng.uniform(-np.pi, np.pi, r)], 1)
    rois[:4, 1:3] = [[img - 1.0, img - 1.0], [-2.0, 100.0], [300.0, 300.0],
                     [0.0, img]]          # on and past the borders
    rois[4, 0] = n + 3                    # a batch index past the last
    return rois.astype(np.float32)


@pytest.mark.parametrize("c,dtype,vec", [(256, torch.bfloat16, 8),
                                         (40, torch.bfloat16, 8),
                                         (32, torch.float32, 4),
                                         (512, torch.bfloat16, 8)])
def test_k1_plan_takes_the_row_design_for_16_byte_vectors(c, dtype, vec):
    plan = k1_plan(c, dtype, 7, 2, rois=16000)
    assert plan["design"] == "rows" and plan["vec"] == vec
    assert plan["warps"] == 8
    # a warp per row of 7 bins; the table: 7 bins x (16 corners x 8 bytes
    # and a count)
    assert plan["blocks"] == 16000 * 7 // 8
    assert plan["smem"] == 8 * 7 * (16 * 8 + 4)
    assert plan["sort"] and not k1_plan(c, dtype, 7, 2, rois=100)["sort"]
    # too many buckets and rois for the order kernel's shared memory: the
    # rois as given
    assert k1_plan(c, dtype, 7, 2, rois=16000, buckets=2720)["sort"]
    assert not k1_plan(c, dtype, 7, 2, rois=16000, buckets=50000)["sort"]
    assert not k1_plan(c, dtype, 7, 2, rois=60000)["sort"]
    assert k1_plan(c, dtype, 7, 1, rois=5)["blocks"] == 5   # ceil(35 / 8)


@pytest.mark.parametrize("c,dtype,s,aligned", [
    (36, torch.bfloat16, 2, True),       # C no multiple of 8: a channel a lane
    (30, torch.float32, 2, True),
    (256, torch.bfloat16, 2, False),     # a level not 16-byte aligned
    (256, torch.bfloat16, 3, True),      # no build for S = 3
    (256, torch.bfloat16, 4, True)])
def test_k1_plan_sends_the_rest_to_the_first_design(c, dtype, s, aligned):
    plan = k1_plan(c, dtype, 7, s, rois=100, aligned=aligned)
    assert plan["design"] == "first" and plan["blocks"] == 100
    assert plan["vec"] == (1 if c % 8 or not aligned else 8)


def test_k1_plan_refuses_what_no_design_takes():
    with pytest.raises(TypeError):
        k1_plan(256, torch.float16)
    for bad in (dict(c=0, dtype=torch.bfloat16),
                dict(c=256, dtype=torch.bfloat16, output_size=0),
                dict(c=256, dtype=torch.bfloat16, sampling_ratio=0)):
        with pytest.raises(ValueError):
            k1_plan(**bad)


def test_k1_row_tables_are_the_corners_of_the_plain_forward():
    """Each (roi, row) table holds, bin by bin, sample (iy, ix) by sample,
    the four corners of ``_corners`` on the roi's level (pixel -1 and
    weight 0 for a dead sample), or, where the bin's live corners fit a
    3 x 3 pixel window, that window: 9 distinct pixels whose weights are
    the bin's corner weights added per pixel, then -1. Rois smaller than
    their level's pixels merge; large ones do not."""
    rng = np.random.RandomState(51)
    feats = [t(f) for f in _pyramid(rng)]
    rois = t(_rois(rng, 80, 2))
    lvl, pix, wts, count = k1_row_tables(feats, rois)
    assert torch.equal(lvl, map_roi_levels(rois[:, 3], rois[:, 4], 4))
    assert pix.shape == wts.shape == (80, 7, 7, 16)
    assert count.shape == (80, 7, 7)
    merged = count == 9
    assert torch.equal(merged | (count == 16), torch.ones_like(merged))
    assert 0 < merged.float().mean() < 1
    assert ((pix < 0) <= (wts == 0)).all()          # nothing loaded: 0
    assert (pix[merged][:, 9:] < 0).all()
    for r in range(80):
        f = feats[lvl[r]]
        live, o, wt = _corners(rois[r:r + 1], f.shape[1], f.shape[2],
                               float(STRIDES[lvl[r]]), 7, 2)
        # [1, 14, 14, 4] -> [py, iy, px, ix, 4] -> [py, px, iy, ix, 4]
        o = torch.where(live[..., None], o, -1).reshape(7, 2, 7, 2, 4) \
            .permute(0, 2, 1, 3, 4).reshape(7, 7, 16)
        wt = torch.where(live[..., None], wt, 0.0).reshape(7, 2, 7, 2, 4) \
            .permute(0, 2, 1, 3, 4).reshape(7, 7, 16)
        assert ((pix[r] < f.shape[1] * f.shape[2]) & (pix[r] >= -1)).all()
        keep = ~merged[r]
        assert torch.equal(pix[r][keep], o[keep])
        assert torch.equal(wts[r][keep], wt[keep])
        for py, px in torch.nonzero(merged[r]).tolist():
            want = {}
            for q, w in zip(o[py, px].tolist(), wt[py, px].tolist()):
                if q >= 0 and w != 0:
                    want[q] = want.get(q, 0.0) + w
            got = {q: w for q, w in zip(pix[r, py, px].tolist(),
                                        wts[r, py, px].tolist()) if q >= 0}
            assert len(got) == sum(q >= 0 for q in pix[r, py, px].tolist())
            assert got.keys() == want.keys()
            assert all(abs(got[q] - want[q]) <= 1e-6 for q in got)


def test_k1_row_design_plain_version_matches_plain_forward_and_jax():
    """The row design's sums (corner by corner in f32, one scaling by
    1 / S^2) against the plain forward (per-sample bilinear values, then
    a mean: the same terms in another order) and against the JAX
    package's exact gather path (on the rois whose batch index is in
    range: past it the port clamps, as its kernels do), f32: within 1e-5
    of the largest value;
    in bf16 one rounding of the same f32 sums on both sides: within one
    bf16 ulp (2^-8) of the largest value."""
    rng = np.random.RandomState(52)
    feats, rois = _pyramid(rng, c=16), _rois(rng, 300, 2)
    got = roi_align_rotated_pyramid_rows_reference([t(f) for f in feats],
                                                   t(rois))
    plain = roi_align_rotated_pyramid_reference([t(f) for f in feats],
                                                t(rois))
    ref = np.asarray(jroi([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                          7, strides=STRIDES))
    scale = np.abs(ref).max()
    assert got.shape == plain.shape == ref.shape
    ok = rois[:, 0] < 2
    assert not ok.all()
    assert np.abs(got.numpy()[ok] - ref[ok]).max() <= 1e-5 * scale
    assert (got - plain).abs().max().item() <= 1e-5 * scale
    bf = [t(f).to(torch.bfloat16) for f in feats]
    got16 = roi_align_rotated_pyramid_rows_reference(bf, t(rois))
    plain16 = roi_align_rotated_pyramid_reference(bf, t(rois))
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - plain16.float()).abs().max().item() \
        <= 2 ** -8 * plain16.float().abs().max().item()


def test_k1_buckets_group_rois_by_level_image_and_cell():
    """The plain version of K1's order: a roi's bucket names its level,
    clamped image and the 16 x 16-pixel cell of the level that holds its
    centre (clamped to the level); the flagship pyramid has 2720
    buckets."""
    rng = np.random.RandomState(55)
    feats = [t(f) for f in _pyramid(rng, n=2)]
    rois = t(_rois(rng, 400, 2))
    bucket, total = k1_buckets(feats, rois)
    sizes = [f.shape[1:3] for f in feats]
    assert total == k1_bucket_count(2, sizes) == 2 * (16 + 4 + 1 + 1)
    assert k1_bucket_count(8, [(256, 256), (128, 128), (64, 64),
                               (32, 32)]) == 2720
    assert ((bucket >= 0) & (bucket < total)).all()
    lvl = map_roi_levels(rois[:, 3], rois[:, 4], 4)
    base = np.cumsum([0] + [2 * -(-h // 16) * -(-w // 16) for h, w in sizes])
    rn = rois.numpy()
    for r in range(400):
        i = int(lvl[r])
        h, w = sizes[i]
        cy, cx = -(-h // 16), -(-w // 16)
        b = min(max(int(rn[r, 0]), 0), 1)
        x = min(max(int(np.floor(rn[r, 1] / (STRIDES[i] * 16))), 0), cx - 1)
        y = min(max(int(np.floor(rn[r, 2] / (STRIDES[i] * 16))), 0), cy - 1)
        assert bucket[r] == base[i] + (b * cy + y) * cx + x


@pytest.mark.parametrize("k,d", [(5, 1), (7, 3)])
def test_dw_plan_of_the_prototype_shape_streams_rows(k, d):
    """[8, 256, 64, 256] bf16: one strip of 256 columns, segments that
    cover every output row of a row class, one warp per (image, segment,
    class, strip, channel), at most about a wave of resident warps."""
    plan = dw_plan(k, d, 256, 256, 64, torch.bfloat16, n=8, hcw=True)
    assert plan["design"] == "chw" and plan["strips"] == 1
    rows = -(-256 // d)
    assert plan["segs"] * plan["seg_rows"] >= rows \
        > (plan["segs"] - 1) * plan["seg_rows"]
    assert plan["warps"] == 8 * plan["segs"] * d * 64
    assert plan["blocks"] == -(-plan["warps"] // 4)
    assert plan["warps"] <= 132 * CHW_WARPS_PER_SM[k]
    assert plan["segs"] == (4 if k == 5 else 1)


@pytest.mark.parametrize("h,w,c,strips", [(37, 200, 64, 1), (64, 264, 64, 2),
                                          (64, 256, 72, 1), (37, 256, 64, 1),
                                          (5, 8, 3, 1)])
@pytest.mark.parametrize("k,d", [(3, 1), (5, 1), (7, 3), (5, 2)])
def test_dw_plan_streams_ragged_chw_shapes(h, w, c, strips, k, d):
    plan = dw_plan(k, d, h, w, c, torch.bfloat16, n=2, hcw=True)
    assert plan["design"] == "chw" and plan["strips"] == strips
    rows = -(-h // d)
    assert plan["segs"] * plan["seg_rows"] >= rows \
        > (plan["segs"] - 1) * plan["seg_rows"]


@pytest.mark.parametrize("k,d,w,dtype,aligned", [
    (7, 3, 256, torch.float32, True),    # f32
    (7, 3, 21, torch.bfloat16, True),    # W no multiple of 8
    (5, 1, 256, torch.bfloat16, False),  # x not 16-byte aligned
    (7, 4, 256, torch.bfloat16, True)])  # no build for dilation 4
def test_dw_plan_sends_other_chw_shapes_to_the_first_design(k, d, w, dtype,
                                                            aligned):
    plan = dw_plan(k, d, 64, w, 64, dtype, n=2, hcw=True, aligned=aligned)
    assert plan["design"] == "first"


@pytest.mark.parametrize("k,d", [(3, 1), (5, 1), (7, 3), (5, 2)])
@pytest.mark.parametrize("segs", [None, 1, 3])
def test_dw_chw_stream_plain_version_matches_plain(k, d, segs):
    """The streaming design's order (row classes, segments, the ring of
    k output rows) gives the plain version's function, f32, with and
    without bias: f32 sums of up to 49 taps in another order."""
    rng = np.random.RandomState(53)
    x = t(rng.randn(2, 37, 12, 24).astype(np.float32))
    wts = t((rng.randn(12, k * k) / k).astype(np.float32))
    bias = t(rng.randn(12).astype(np.float32))
    rows = -(-37 // d)
    if segs is None:
        plan = dw_plan(k, d, 37, 24, 12, torch.bfloat16, n=2, hcw=True)
        segs, per = plan["segs"], plan["seg_rows"]
    else:
        per = -(-rows // segs)
    ref = dw_chw_reference(x, wts, k, d)
    got = dw_chw_stream_reference(x, wts, k, d, segs, per)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    got = dw_chw_stream_reference(x, wts, k, d, segs, per, bias=bias)
    torch.testing.assert_close(got, ref + bias[None, None, :, None],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,dil", [(5, 1), (7, 3)])
def test_dw_chw_matches_jax_prototype_at_a_ragged_shape(k, dil):
    """``dw_chw`` (the plain version on the CPU) and the streaming
    design's plain version against the Pallas prototype in interpret
    mode at H = 37, W = 21: f32 sums of up to 49 taps in another
    order."""
    spec = importlib.util.spec_from_file_location(
        "chw_dw_proto", os.path.join(REPO, "tools", "analysis_tools",
                                     "chw_dw_proto.py"))
    proto = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proto)
    rng = np.random.RandomState(54)
    x = rng.randn(2, 37, 12, 21).astype(np.float32)      # [N, H, C, W]
    wts = (rng.randn(12, k * k) * 0.1).astype(np.float32)
    ref = np.asarray(proto.dw_chw(jnp.asarray(x), jnp.asarray(wts), k, dil,
                                  bh=8, interpret=True))
    got = dw_chw(t(x), t(wts), k, dil)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)
    rows = -(-37 // dil)
    stream = dw_chw_stream_reference(t(x), t(wts), k, dil, 3, -(-rows // 3))
    np.testing.assert_allclose(stream.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_new_wrapper_paths_refuse_before_the_library_is_built(monkeypatch):
    def no_build():
        raise AssertionError("the kernel library must not be built here")

    monkeypatch.setattr(roi_align, "kernel_library", no_build)
    monkeypatch.setattr(dwconv, "kernel_library", no_build)
    feats = [torch.zeros(1, s, s, 256) for s in (16, 8, 4, 2)]
    rois = torch.zeros(3, 6)
    for fn in (roi_align.roi_align_rotated_pyramid_cuda,
               roi_align.roi_align_rotated_pyramid_first_design):
        with pytest.raises(ValueError):      # CPU tensors
            fn(feats, rois)
        with pytest.raises(TypeError):       # a dtype no kernel takes
            fn([f.half() for f in feats], rois)
    x = torch.zeros(1, 8, 64, 256, dtype=torch.bfloat16)
    w = torch.zeros(64, 25, dtype=torch.bfloat16)
    for fn in (dwconv.dw_chw_cuda, dwconv.dw_chw_first_design):
        with pytest.raises(ValueError):      # CPU tensors
            fn(x, w, 5, 1)
    with pytest.raises(TypeError):
        dwconv.dw_chw_cuda(x.half(), w.half(), 5, 1)
