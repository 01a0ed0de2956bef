"""The port's box toolbox against the JAX package on the CPU: the
extended transforms (``ops/bbox_transforms.py``, the mask path against
JAX's OpenCV calls), the host geometry (``ops/bbox_geometry.py``), the
``box_ops`` packing and conversions, ``poly_iou`` and
``box_iou_rotated_v1``, the hbb and per-class poly NMS, the anchor
helpers, ``bbox_overlaps_np``, ``mergebyobb``, ``dcn_offset_grid`` and
the legacy creators. Seeded numpy inputs; the JAX functions take jnp
arrays (their device path) unless they are host numpy.

Tolerances: index and integer work exactly (NMS keeps, labels, the
creators' draws, levels, flags, box types); float work 1e-5 absolute at
O(1)-O(100) values relative to their scale (f32 on both sides, sines and
logs an ulp apart); the host numpy copies bit for bit. The mask path's
rectangles: see ``test_mask2poly_matches_opencv``."""

import importlib
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.data.devkits import result_merge as jmerge
from rs_detection_tpu.models.boxes import anchor_target as jat
from rs_detection_tpu.models.boxes import iou_calculator as jiou
from rs_detection_tpu.models.roi_heads import legacy_creators as jlc
from rs_detection_tpu.ops import bbox_geometry as jgeo
from rs_detection_tpu.ops import bbox_transforms as jbt
from rs_detection_tpu.ops import box_ops as jbox
from rs_detection_tpu.ops import deform_conv as jdc
from rs_detection_tpu.ops import nms_poly as jnp_poly
from rs_detection_tpu.ops import rotated_iou as jri
from rs_detection_tpu_torch.data.devkits import result_merge as merge
from rs_detection_tpu_torch.models.boxes import anchor_target as at
from rs_detection_tpu_torch.models.boxes import iou_calculator as iou
from rs_detection_tpu_torch.models.roi_heads import legacy_creators as lc
from rs_detection_tpu_torch.ops import bbox_geometry as geo
from rs_detection_tpu_torch.ops import bbox_transforms as bt
from rs_detection_tpu_torch.ops import box_ops as B
from rs_detection_tpu_torch.ops import deform_conv as dc
from rs_detection_tpu_torch.ops import min_area_rect as mar
from rs_detection_tpu_torch.ops import nms
from rs_detection_tpu_torch.ops import nms_poly
from rs_detection_tpu_torch.ops import rotated_iou as ri
from torch_one_thread import _one_thread  # noqa: F401

# the package's ``ops`` exports a function of the module's name
jnms = importlib.import_module("rs_detection_tpu.ops.nms")
TOL = 1e-5


def _obbs(seed, n=32, img=100.0):
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(0, img, n), rng.uniform(0, img, n),
                     rng.uniform(4, 40, n), rng.uniform(4, 40, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


def _hbbs(seed, n=32, img=100.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, img, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(2, 40, (n, 2))],
                          1).astype(np.float32)


def _close(got, ref, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= tol * scale, np.abs(got - ref).max()


# ---------------------------------------------------------------------------
# ops/bbox_transforms.py

CODERS = ["dbbox2delta_v2", "dbbox2delta_v3", "best_match_dbbox2delta"]
DECODERS = ["delta2dbbox_v2", "delta2dbbox_v3"]


@pytest.mark.parametrize("name", CODERS)
def test_delta_coders_match_jax(name):
    props, gts = _obbs(1), _obbs(2)
    means, stds = (0.1, -0.2, 0.0, 0.05, 0.0), (0.1, 0.1, 0.2, 0.2, 0.1)
    ref = getattr(jbt, name)(jnp.asarray(props), jnp.asarray(gts), means,
                             stds)
    got = getattr(bt, name)(torch.from_numpy(props), torch.from_numpy(gts),
                            means, stds)
    _close(got, ref)
    # numpy in, numpy out, as the JAX function's numpy path
    out = getattr(bt, name)(props, gts, means, stds)
    assert isinstance(out, np.ndarray)
    _close(out, getattr(jbt, name)(props, gts, means, stds))


@pytest.mark.parametrize("name", DECODERS)
def test_delta_decoders_match_jax(name):
    rois = _obbs(3)
    deltas = np.random.RandomState(4).randn(32, 5).astype(np.float32) * 0.3
    deltas[0, 2] = 9.0                      # past the ratio clip
    means, stds = (0.0,) * 5, (0.1, 0.1, 0.2, 0.2, 0.1)
    ref = getattr(jbt, name)(jnp.asarray(rois), jnp.asarray(deltas), means,
                             stds, wh_ratio_clip=0.05)
    got = getattr(bt, name)(torch.from_numpy(rois), torch.from_numpy(deltas),
                            means, stds, wh_ratio_clip=0.05)
    _close(got, ref)


@pytest.mark.parametrize("name", ["hbb2obb_v2", "choose_best_Rroi_batch",
                                  "choose_best_obb_batch", "roi2droi",
                                  "choose_best_match_batch"])
def test_box_selections_match_jax(name):
    obbs = _obbs(5)
    obbs[:4, 2:4] = 10.0                    # squares: swaps tie
    if name == "hbb2obb_v2":
        args = [_hbbs(6)]
    elif name == "roi2droi":
        args = [np.concatenate([np.random.RandomState(7).randint(
            0, 3, (32, 1)).astype(np.float32), _hbbs(7)], 1)]
    elif name == "choose_best_match_batch":
        args = [_obbs(8), obbs]
    else:
        args = [obbs]
    ref = getattr(jbt, name)(*[jnp.asarray(a) for a in args])
    got = getattr(bt, name)(*[torch.from_numpy(a) for a in args])
    _close(got, ref)


def test_polygon_fit_and_dbbox2result_match_jax():
    polys = B.rotated_box_to_poly_np(_obbs(9))
    for mod in (True, False):
        np.testing.assert_array_equal(
            bt.polygonToRotRectangle_batch(polys, mod),
            jbt.polygonToRotRectangle_batch(polys, mod))
    dets = np.random.RandomState(10).rand(20, 9).astype(np.float32)
    labels = np.random.RandomState(10).randint(0, 5, 20)
    for a, b in zip(bt.dbbox2result(dets, labels, 6),
                    jbt.dbbox2result(dets, labels, 6)):
        np.testing.assert_array_equal(a, b)


def blob_masks(seed, n=50, size=64):
    """Seeded binary masks: filled ellipses, rotated rectangles, axis
    squares, and ellipses with pixels knocked out (holes, several
    components), one to three shapes each."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:size, :size]
    masks = []
    for i in range(n):
        m = np.zeros((size, size), bool)
        kind = i % 4
        for _ in range(rng.randint(1, 4)):
            cx, cy = rng.uniform(8, size - 8, 2)
            a, b = rng.uniform(2, 20, 2)
            t = rng.uniform(0, np.pi)
            u = (xx - cx) * np.cos(t) + (yy - cy) * np.sin(t)
            v = -(xx - cx) * np.sin(t) + (yy - cy) * np.cos(t)
            if kind == 1:
                m |= (np.abs(u) <= a) & (np.abs(v) <= b)
            elif kind == 2:
                s = rng.randint(2, 15)
                x0, y0 = int(cx) - s // 2, int(cy) - s // 2
                m[y0:y0 + s, x0:x0 + s] = True
            else:
                m |= (u / a) ** 2 + (v / b) ** 2 <= 1
                if kind == 3:
                    m &= rng.rand(size, size) > 0.15
        masks.append(m.astype(np.uint8))
    return masks


def test_mask2poly_matches_opencv():
    """50 seeded blob masks through the JAX function (OpenCV's
    ``findContours`` / ``contourArea`` / ``minAreaRect`` / ``boxPoints``)
    and the port's OpenCV-free chain: the same external contours, hulls
    and largest contour; the corners in the same order within 1e-4 px
    where one rectangle has the least area. Where OpenCV's rectangle and
    the port's differ (two rectangles tie for the least area, a square
    blob), both have that area to 1e-5 and enclose the contour. The
    obbs of ``gt_mask_bp_obbs`` (the le135 edge fit of those corners)
    agree to 1e-4 on the masks whose corners agree, the angle modulo
    pi."""
    masks = blob_masks(11)
    agree = []
    for m in masks:
        cs, _ = cv2.findContours(m, cv2.RETR_EXTERNAL,
                                 cv2.CHAIN_APPROX_SIMPLE)
        mine = mar.external_contours(m)
        assert len(cs) == len(mine)
        for c, d in zip(cs, mine):
            np.testing.assert_array_equal(c.reshape(-1, 2), d)
        big = max(cs, key=cv2.contourArea).reshape(-1, 2)
        np.testing.assert_array_equal(max(mine, key=mar.contour_area), big)
        np.testing.assert_array_equal(mar.convex_hull(big),
                                      cv2.convexHull(big, clockwise=True)
                                      .reshape(-1, 2))
        ref = jbt.mask2poly_single(m)
        got = bt.mask2poly_single(m)
        assert got.dtype == np.float32 and got.shape == (4, 2)
        if np.abs(got - ref).max() <= 1e-4:
            agree.append(m)
            continue
        areas = [np.prod(cv2.minAreaRect(p)[1]) for p in (ref, got)]
        assert abs(areas[0] - areas[1]) <= 1e-5 * areas[0]
        for rect in (ref, got):
            inside = cv2.pointPolygonTest
            assert all(inside(rect, (float(x), float(y)), True) >= -1e-3
                       for x, y in big)
    assert len(agree) >= 45
    np.testing.assert_allclose(np.stack(bt.mask2poly(agree)),
                               np.stack(jbt.mask2poly(agree)), atol=1e-4)
    # an edge at the le135 wrap (-pi/4) may land on either side of it:
    # the angles are held modulo pi, the period of a box's angle
    def same_obbs(a, b):
        d = a - b
        d[:, 4] = (d[:, 4] + np.pi / 2) % np.pi - np.pi / 2
        assert np.abs(d).max() <= 1e-4, np.abs(d).max()

    same_obbs(bt.gt_mask_bp_obbs(agree), jbt.gt_mask_bp_obbs(agree))
    for a, b in zip(bt.gt_mask_bp_obbs_list([agree[:3], agree[3:5]]),
                    jbt.gt_mask_bp_obbs_list([agree[:3], agree[3:5]])):
        same_obbs(a, b)
    np.testing.assert_array_equal(bt.mask2poly_single(np.zeros((8, 8))),
                                  np.zeros((4, 2), np.float32))


# ---------------------------------------------------------------------------
# ops/bbox_geometry.py (host numpy copies: bit for bit)

@pytest.mark.parametrize("kinds", [("hbb", "hbb"), ("obb", "hbb"),
                                   ("poly", "obb"), ("poly", "poly")])
@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_bbox_overlaps_matches_jax(kinds, mode):
    make = {"hbb": lambda s: _hbbs(s, 12), "obb": lambda s: _obbs(s, 12),
            "poly": lambda s: B.rotated_box_to_poly_np(_obbs(s, 12))}
    a, b = make[kinds[0]](12), make[kinds[1]](13)
    np.testing.assert_array_equal(geo.bbox_overlaps(a, b, mode),
                                  jgeo.bbox_overlaps(a, b, mode))
    if kinds[0] == kinds[1]:
        np.testing.assert_array_equal(
            geo.bbox_overlaps(a, b, mode, is_aligned=True),
            jgeo.bbox_overlaps(a, b, mode, is_aligned=True))


def test_bbox_areas_and_nms_match_jax():
    for boxes in (_hbbs(14), _obbs(14), B.rotated_box_to_poly_np(_obbs(14))):
        np.testing.assert_array_equal(geo.bbox_areas(boxes),
                                      jgeo.bbox_areas(boxes))
        scores = np.random.RandomState(15).rand(len(boxes)).astype(
            np.float32)
        for thr in (0.1, 0.5):
            np.testing.assert_array_equal(
                geo.bbox_nms(boxes, scores, thr, 0.2),
                jgeo.bbox_nms(boxes, scores, thr, 0.2))
            np.testing.assert_array_equal(geo.bbox_area_nms(boxes, thr),
                                          jgeo.bbox_area_nms(boxes, thr))


# ---------------------------------------------------------------------------
# ops/box_ops.py

def test_bbox_type_dim_and_roi_packing_match_jax():
    for dim in (4, 5, 8, 6, 9):
        x = np.zeros((2, dim), np.float32)
        for ws in (False, True):
            assert B.get_bbox_type(x, ws) == jbox.get_bbox_type(x, ws)
            assert B.get_bbox_type(torch.from_numpy(x), ws) \
                == jbox.get_bbox_type(x, ws)
    for t in ("hbb", "obb", "poly"):
        for ws in (False, True):
            assert B.get_bbox_dim(t, ws) == jbox.get_bbox_dim(t, ws)
    boxes = [_obbs(16, 3), _obbs(17, 0), np.concatenate(
        [_obbs(18, 2), np.ones((2, 1), np.float32)], 1)]
    np.testing.assert_array_equal(B.arb2roi(boxes), jbox.arb2roi(boxes))
    np.testing.assert_array_equal(B.arb2roi(boxes, 4), jbox.bbox2roi(boxes))
    np.testing.assert_array_equal(B.bbox2roi(boxes), jbox.bbox2roi(boxes))
    got = B.arb2roi([torch.from_numpy(b) for b in boxes])
    np.testing.assert_array_equal(got.numpy(), jbox.arb2roi(boxes))
    np.testing.assert_array_equal(
        B.bbox2roi([torch.from_numpy(b) for b in boxes]).numpy(),
        np.asarray(jbox.bbox2roi([jnp.asarray(b) for b in boxes])))


def test_polygon_conversions_match_jax():
    polys = np.concatenate([jbox.rotated_box_to_poly_np(_obbs(19)),
                            np.random.RandomState(20).rand(32, 8)
                            .astype(np.float32) * 50], 0)
    scored = np.concatenate([polys, np.arange(64, dtype=np.float32)[:, None]],
                            1)
    for x in (polys, scored):
        np.testing.assert_array_equal(B.get_best_begin_point(x),
                                      jbox.get_best_begin_point(x))
        np.testing.assert_array_equal(
            B.get_best_begin_point(torch.from_numpy(x)).numpy(),
            np.asarray(jbox.get_best_begin_point(jnp.asarray(x))))
    for version in ("le135", "le90"):
        _close(B.poly_to_rotated_box(torch.from_numpy(polys), version),
               jbox.poly_to_rotated_box(jnp.asarray(polys), version))
    _close(B.rotated_box_to_bbox(torch.from_numpy(_obbs(21))),
           jbox.rotated_box_to_bbox(jnp.asarray(_obbs(21))))


# ---------------------------------------------------------------------------
# ops/rotated_iou.py

def _convex_quads(seed, n):
    """Rotated rectangles, and quads with each corner pulled toward the
    centre (convex)."""
    polys = jbox.rotated_box_to_poly_np(_obbs(seed, n, 60.0))
    pts = polys.reshape(n, 4, 2)
    centre = pts.mean(1, keepdims=True)
    pull = np.random.RandomState(seed).uniform(0.0, 0.3, (n, 4, 1))
    pts[n // 2:] = (pts + (centre - pts) * pull)[n // 2:]
    return pts.reshape(n, 8).astype(np.float32)


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_poly_iou_matches_jax(mode):
    """Pairwise over 40 x 36 quads in a 60 px field (many overlaps),
    against the JAX function; 1e-5, away from the candidate order's
    near-ties of ROADMAP Queue 3 (none among these inputs at that
    tolerance)."""
    a, b = _convex_quads(22, 40), _convex_quads(23, 36)
    ref = np.asarray(jri.poly_iou(jnp.asarray(a), jnp.asarray(b), mode))
    got = ri.poly_iou(torch.from_numpy(a), torch.from_numpy(b), mode,
                      pair_block=200)
    assert (ref > 0).mean() > 0.1
    _close(got, ref)
    assert ri.poly_iou(torch.zeros(0, 8), torch.from_numpy(b)).shape == (0, 36)


def test_box_iou_rotated_v1_matches_jax():
    a, b = _obbs(24, 20, 60.0), _obbs(25, 16, 60.0)
    for mode in ("iou", "iof"):
        _close(ri.box_iou_rotated_v1(torch.from_numpy(a),
                                     torch.from_numpy(b), mode),
               jri.box_iou_rotated_v1(jnp.asarray(a), jnp.asarray(b), mode))


# ---------------------------------------------------------------------------
# ops/nms.py, ops/nms_poly.py: keeps exactly

def _nms_inputs(seed, n=64):
    rng = np.random.RandomState(seed)
    boxes = _hbbs(seed, n, 80.0)
    scores = rng.rand(n).astype(np.float32)
    scores[5:9] = scores[4]                 # ties: the stable order decides
    valid = rng.rand(n) > 0.2
    return boxes, scores, valid


@pytest.mark.parametrize("thr", [0.3, 0.6])
def test_nms_matches_jax(thr):
    boxes, scores, valid = _nms_inputs(26)
    for v in (None, valid):
        ref = np.asarray(jnms.nms_mask(
            jnp.asarray(boxes), jnp.asarray(scores), thr,
            None if v is None else jnp.asarray(v)))
        got = nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores),
                           thr, None if v is None else torch.from_numpy(v))
        np.testing.assert_array_equal(got.numpy(), ref)
        assert 0 < ref.sum() < len(ref)
    np.testing.assert_array_equal(nms.nms(boxes, scores, thr),
                                  jnms.nms(boxes, scores, thr))
    assert nms.nms(np.zeros((0, 4)), np.zeros(0), thr).shape == (0,)


def test_multiclass_nms_matches_jax():
    boxes, _, _ = _nms_inputs(27)
    scores = np.random.RandomState(28).rand(64, 4).astype(np.float32)
    for kw in (dict(max_num=-1), dict(max_num=10)):
        got = nms.multiclass_nms(boxes, scores, 0.3, dict(iou_thr=0.4), **kw)
        ref = jnms.multiclass_nms(boxes, scores, 0.3, dict(iou_thr=0.4),
                                  **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    empty = nms.multiclass_nms(boxes, scores, 2.0, {})
    assert empty[0].shape == (0, 5) and empty[1].shape == (0,)


def test_multiclass_poly_nms_matches_jax():
    polys = B.rotated_box_to_poly_np(_obbs(29, 48, 80.0))
    scores = np.random.RandomState(30).rand(48, 3).astype(np.float32)
    for max_num in (-1, 7):
        got = nms_poly.multiclass_poly_nms(polys, scores, 0.2, 0.3, max_num)
        ref = jnp_poly.multiclass_poly_nms(polys, scores, 0.2, 0.3, max_num)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


# ---------------------------------------------------------------------------
# anchors, IoU calculator, merge, the tap grid

def test_anchor_helpers_match_jax():
    anchors = _hbbs(31, 40, 70.0) - 10.0
    valid = np.random.RandomState(32).rand(40) > 0.3
    for border in (-1, 0, 5):
        ref = np.asarray(jat.anchor_inside_flags(
            jnp.asarray(anchors), jnp.asarray(valid), (64, 48), border))
        got = at.anchor_inside_flags(torch.from_numpy(anchors),
                                     torch.from_numpy(valid), (64, 48),
                                     border)
        np.testing.assert_array_equal(got.numpy(), ref)
    t = np.arange(2 * 10 * 3).reshape(2, 10, 3)
    for g, r in zip(at.images_to_levels(torch.from_numpy(t), [6, 3, 1]),
                    jat.images_to_levels(jnp.asarray(t), [6, 3, 1])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_bbox_overlaps_np_matches_jax():
    a, b = _hbbs(33, 10), _hbbs(34, 7)
    for mode in ("iou", "iof"):
        _close(iou.bbox_overlaps_np(a, b, mode),
               jiou.bbox_overlaps_np(a, b, mode))


def test_mergebyobb_matches_jax(tmp_path):
    """Two class files of tile detections, merged by both packages: the
    same files, byte for byte."""
    src = tmp_path / "before"
    src.mkdir()
    rng = np.random.RandomState(35)
    for cls in ("plane", "ship"):
        lines = []
        for _ in range(30):
            tile = f"P{rng.randint(2)}__1.0__{rng.choice([0, 512])}___0"
            poly = B.rotated_box_to_poly_np(_obbs(rng.randint(1000), 1,
                                                  600.0))[0]
            lines.append(f"{tile} {rng.rand():.3f} "
                         + " ".join(f"{v:.1f}" for v in poly))
        (src / f"{cls}.txt").write_text("\n".join(lines) + "\n")
    out = {}
    for name, fn in (("port", merge.mergebyobb), ("jax", jmerge.mergebyobb)):
        dst = tmp_path / name
        fn(str(src), str(dst), num_process=1)
        out[name] = {f: (dst / f).read_bytes() for f in os.listdir(dst)}
    assert out["port"] == out["jax"] and len(out["port"]) == 2


def test_dcn_offset_grid_matches_jax():
    for k in (1, 3, 5):
        for g, r in zip(dc.dcn_offset_grid(k), jdc.dcn_offset_grid(k)):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# models/roi_heads/legacy_creators.py (host numpy: bit for bit, the same
# draws from the same generator)

def test_loc_coders_and_iou_match_jax():
    src, dst = _hbbs(36, 20), _hbbs(37, 20)
    np.testing.assert_array_equal(lc.bbox2loc(src, dst),
                                  jlc.bbox2loc(src, dst))
    loc = lc.bbox2loc(src, dst, (0.1, 0, 0, 0), (0.1, 0.1, 0.2, 0.2))
    np.testing.assert_array_equal(
        lc.loc2bbox(src, loc, (0.1, 0, 0, 0), (0.1, 0.1, 0.2, 0.2)),
        jlc.loc2bbox(src, loc, (0.1, 0, 0, 0), (0.1, 0.1, 0.2, 0.2)))
    np.testing.assert_allclose(lc.loc2bbox(src, lc.bbox2loc(src, dst)), dst,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(lc.bbox_iou(src, dst),
                                  jlc.bbox_iou(src, dst))


@pytest.mark.parametrize("rng", ["global", "random_state", "generator"])
def test_target_creators_draw_as_jax(rng):
    """Anchor and proposal targets with subsampling (more positives and
    negatives than slots), drawn from the global ``np.random`` seeded
    alike, a ``RandomState`` or a ``Generator``: the same labels, locs and
    rois."""
    def gen():
        if rng == "global":
            np.random.seed(38)
            return None
        if rng == "random_state":
            return np.random.RandomState(38)
        return np.random.default_rng(38)

    anchors = _hbbs(39, 300, 60.0) - 5.0
    gts = _hbbs(40, 6, 60.0)
    outs = []
    for mod in (lc, jlc):
        a = mod.AnchorTargetCreator(n_sample=64, pos_iou_thresh=0.5,
                                    neg_iou_thresh=0.3, rng=gen())
        loc, label = a(gts, anchors, (64, 64))
        p = mod.ProposalTargetCreator(n_sample=32, pos_ratio=0.25,
                                      pos_iou_thresh=0.3, rng=gen())
        outs.append((loc, label) + p(anchors[:120], gts,
                                     np.arange(6) % 3))
    assert (outs[0][1] == 1).sum() > 0 and (outs[0][1] == -1).sum() > 0
    for g, r in zip(*outs):
        np.testing.assert_array_equal(g, r)


def test_proposal_creator_matches_jax():
    anchors = _hbbs(41, 200, 60.0)
    loc = np.random.RandomState(42).randn(200, 4).astype(np.float32) * 0.2
    score = np.random.RandomState(43).rand(200).astype(np.float32)
    for training in (False, True):
        kw = dict(nms_thresh=0.5, n_train_pre_nms=150, n_train_post_nms=40,
                  n_test_pre_nms=100, n_test_post_nms=20, min_size=4)
        got = lc.ProposalCreator(**kw)(loc, score, anchors, (64, 64),
                                       training)
        ref = jlc.ProposalCreator(**kw)(loc, score, anchors, (64, 64),
                                        training)
        np.testing.assert_array_equal(got, ref)
        assert 1 < len(got) <= (40 if training else 20)
