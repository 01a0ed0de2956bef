"""Box toolbox of the PyTorch port against its JAX twins: anchors,
obb conversions, both decoders, the RPN's NMS pieces, top-k and GELU.
Inputs come from seeded numpy; everything runs in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.models.boxes import anchor_generator as jag
from rs_detection_tpu.models.boxes import coder as jcoder
from rs_detection_tpu.ops import box_ops as jbox
from rs_detection_tpu.ops.nms import _greedy_suppress_mask, overlap_gt_mask_hbb
from rs_detection_tpu.ops.activations import exact_gelu as jgelu
from rs_detection_tpu_torch.models.boxes import anchor_generator as tag
from rs_detection_tpu_torch.models.boxes import coder as tcoder
from rs_detection_tpu_torch.ops import box_ops as tbox
from rs_detection_tpu_torch.ops import nms as tnms
from rs_detection_tpu_torch.ops.activations import exact_gelu as tgelu

# f32 elementwise math on both sides; box coordinates are O(100) px,
# so 1e-4 px absolute is a few float ulps there
ATOL = 1e-4


def _obbs(rng, n, img=512.0):
    return np.stack([rng.uniform(0, img, n), rng.uniform(0, img, n),
                     rng.uniform(2, 300, n), rng.uniform(2, 300, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


def _close(got, ref, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=1e-5)


def _close_polys(got, ref):
    """Decoded quads: theta is an atan2 of vertex differences, so a
    thin box carries an angle error of a few ulps of its coordinates
    over its short side, times its length (clamped dw/dh make boxes up
    to ~60x their anchor); the bound scales with the row's largest
    coordinate. A wrong formula is off by pixels, not by 5e-5."""
    got, ref = got.numpy(), np.asarray(ref)
    tol = 1e-3 + 5e-5 * np.abs(ref).max(axis=-1, keepdims=True)
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("sizes", [[(32, 32), (16, 16), (8, 8), (4, 4),
                                    (2, 2)],
                                   [(25, 19), (13, 10), (7, 5), (4, 3),
                                    (2, 2)]])
def test_anchors_match(sizes):
    cfg = dict(scales=[8], ratios=[0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0],
               strides=[4, 8, 16, 32, 64])
    ref = jag.AnchorGenerator(**cfg).grid_anchors(sizes)
    got = tag.AnchorGenerator(**cfg).grid_anchors(sizes)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["obb2hbb", "obb2poly", "regular_obb"])
def test_obb_conversions_match(fn):
    obb = _obbs(np.random.RandomState(0), 257)
    _close(getattr(tbox, fn)(torch.from_numpy(obb)),
           getattr(jbox, fn)(jnp.asarray(obb)))


def test_rectpoly2obb_matches():
    obb = _obbs(np.random.RandomState(1), 257)
    poly = np.array(jbox.obb2poly(jnp.asarray(obb)))
    _close(tbox.rectpoly2obb(torch.from_numpy(poly)),
           jbox.rectpoly2obb(jnp.asarray(poly)), atol=2e-4)


def test_midpoint_offset_decode_matches():
    rng = np.random.RandomState(2)
    n = 300
    x0 = rng.uniform(0, 500, n)
    y0 = rng.uniform(0, 500, n)
    anchors = np.stack([x0, y0, x0 + rng.uniform(4, 200, n),
                        y0 + rng.uniform(4, 200, n)], 1).astype(np.float32)
    # wide enough to hit every clamp (dw/dh ratio clip, da/db +-0.5)
    deltas = rng.randn(n, 6).astype(np.float32) * 2.0
    stds = (1.0, 1.0, 1.0, 1.0, 0.5, 0.5)
    ref = jcoder.midpoint_offset_decode(jnp.asarray(anchors),
                                        jnp.asarray(deltas), (0.0,) * 6, stds)
    got = tcoder.midpoint_offset_decode(torch.from_numpy(anchors),
                                        torch.from_numpy(deltas), (0.0,) * 6,
                                        stds)
    # theta is an atan2 of decoded coordinates: compare the geometry
    # through obb2poly, which is continuous across the theta wrap
    _close_polys(tbox.obb2poly(got), jbox.obb2poly(ref))


def test_oriented_delta_decode_matches():
    rng = np.random.RandomState(3)
    rois = _obbs(rng, 300)
    deltas = rng.randn(300, 5).astype(np.float32)
    means, stds = (0.0,) * 5, (0.1, 0.1, 0.2, 0.2, 0.1)
    ref = jcoder.oriented_delta_decode(jnp.asarray(rois),
                                       jnp.asarray(deltas), means, stds)
    got = tcoder.oriented_delta_decode(torch.from_numpy(rois),
                                       torch.from_numpy(deltas), means, stds)
    _close_polys(tbox.obb2poly(got), jbox.obb2poly(ref))
    np.testing.assert_allclose(got.numpy()[:, 2:4], np.asarray(ref)[:, 2:4],
                               rtol=1e-5)


def _clustered_hbbs(rng, b, n):
    """Boxes in a few tight clusters, so suppression chains form."""
    centers = rng.uniform(50, 450, (b, 6, 2))
    pick = rng.randint(0, 6, (b, n))
    c = np.take_along_axis(centers, pick[..., None], 1) \
        + rng.randn(b, n, 2) * 6
    wh = rng.uniform(20, 60, (b, n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


@pytest.mark.parametrize("thresh", [0.5, 0.8])
def test_nms_keep_masks_equal(thresh):
    rng = np.random.RandomState(4)
    b, n = 3, 96
    boxes = _clustered_hbbs(rng, b, n)
    valid = rng.rand(b, n) > 0.1
    over_t = tnms.overlap_gt_mask_hbb(torch.from_numpy(boxes), thresh)
    over_j = jax.vmap(lambda x: overlap_gt_mask_hbb(x, thresh))(
        jnp.asarray(boxes))
    np.testing.assert_array_equal(over_t.numpy(), np.asarray(over_j))
    keep_t = tnms.greedy_suppress_mask(over_t, torch.from_numpy(valid))
    keep_j = jax.vmap(_greedy_suppress_mask)(over_j, jnp.asarray(valid))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    # something was suppressed, so the fixpoint did real work
    assert keep_t.sum() < torch.from_numpy(valid).sum()


def test_top_k_ties_go_to_the_lower_index():
    rng = np.random.RandomState(5)
    x = rng.randint(0, 7, (4, 50)).astype(np.float32)
    x[:, -5:] = -np.inf
    vals, idx = tnms.top_k(torch.from_numpy(x), 48)
    rv, ri = jax.lax.top_k(jnp.asarray(x), 48)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rv))


def test_exact_gelu_matches():
    x = np.linspace(-8, 8, 4001).astype(np.float32)
    # the JAX erf polynomial is within 1.5e-7 of exact erf, scaled by
    # |x| / 2 <= 4 here, plus f32 rounding
    _close(tgelu(torch.from_numpy(x)), jgelu(jnp.asarray(x)), atol=2e-6)
