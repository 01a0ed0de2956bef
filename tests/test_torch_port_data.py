"""The port's host-side data of the test task against the JAX package:
the numpy box conversions, ``RotatedResize`` / ``Pad`` / ``Normalize``,
``collate_batch``, ``ImageDataset.batches`` with each flip mode, the
polygon NMS (the port's numpy version, its native core and the JAX
package's) and the tile merge with its submissions, byte for byte."""

import os
import pickle
import zipfile
from functools import partial

import numpy as np
import pytest
from PIL import Image

from rs_detection_tpu.data import collate as jcollate
from rs_detection_tpu.data import transforms as jtransforms
from rs_detection_tpu.data.devkits import data_merge as jdata_merge
from rs_detection_tpu.data.devkits import result_merge as jresult_merge
from rs_detection_tpu.data.image import ImageDataset as JImageDataset
from rs_detection_tpu.ops import box_ops as jbox
from rs_detection_tpu.ops import nms_poly as jnms_poly
from rs_detection_tpu_torch.data import collate, transforms
from rs_detection_tpu_torch.data.devkits import data_merge, result_merge
from rs_detection_tpu_torch.data.image import ImageDataset
from rs_detection_tpu_torch.data.io import load_rgb_array
from rs_detection_tpu_torch.ops import box_ops
from rs_detection_tpu_torch.ops import nms_poly

NORM = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_bgr=False)


def _rboxes(rng, n, size):
    return np.stack([rng.uniform(0, size, n), rng.uniform(0, size, n),
                     rng.uniform(4, 60, n), rng.uniform(4, 30, n),
                     rng.uniform(-np.pi / 2, np.pi / 2, n)],
                    1).astype(np.float32)


@pytest.mark.parametrize("angle_version", ["le90", "le135"])
def test_box_conversions_match_jax(angle_version):
    rng = np.random.RandomState(0)
    r = _rboxes(rng, 64, 200)
    poly = box_ops.rotated_box_to_poly_np(r, angle_version)
    np.testing.assert_array_equal(
        poly, jbox.rotated_box_to_poly_np(r, angle_version))
    np.testing.assert_array_equal(
        box_ops.poly_to_rotated_box_np(poly, angle_version),
        jbox.poly_to_rotated_box_np(poly, angle_version))
    theta = rng.uniform(-7, 7, 100)
    np.testing.assert_array_equal(box_ops.norm_angle(theta, angle_version),
                                  jbox.norm_angle(theta, angle_version))
    assert box_ops.rotated_box_to_poly_np(np.zeros((0, 5))).shape == (0, 8)
    assert box_ops.poly_to_rotated_box_np(np.zeros((0, 8))).shape == (0, 5)


def _sample(rng, w, h):
    img = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    target = dict(img_size=img.size, ori_img_size=img.size,
                  scale_factor=1.0,
                  rboxes=_rboxes(rng, 12, min(w, h)),
                  polys=rng.uniform(0, min(w, h), (12, 8)).astype(np.float32),
                  hboxes=rng.uniform(0, min(w, h), (12, 4)).astype(np.float32))
    return img, target


@pytest.mark.parametrize("w,h,min_size,max_size", [
    (150, 100, 128, 256), (96, 160, 128, 160), (128, 128, 128, 128)],
    ids=["up", "capped", "unchanged"])
def test_transforms_match_jax(w, h, min_size, max_size):
    """RotatedResize -> Pad(32) -> Normalize on a seeded image with
    rotated, polygon and horizontal boxes: equal images and targets."""
    pipeline = [dict(type="RotatedResize", min_size=min_size,
                     max_size=max_size, angle_version="le90"),
                dict(type="Pad", size_divisor=32), NORM]
    img, target = _sample(np.random.RandomState(w), w, h)
    got_img, got = transforms.Compose(pipeline)(img, dict(target))
    ref_img, ref = jtransforms.Compose(pipeline)(img, dict(target))
    np.testing.assert_array_equal(got_img, ref_img)
    assert got_img.dtype == np.float32 and got_img.shape[0] % 32 == 0
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


def test_pad_to_size_and_errors():
    img, _ = _sample(np.random.RandomState(1), 50, 40)
    got, tg = transforms.Pad(size=(64, 48), pad_val=7)(img, {})
    ref, tr = jtransforms.Pad(size=(64, 48), pad_val=7)(img, {})
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    assert tg == tr == {"pad_shape": (64, 48)}
    with pytest.raises(ValueError):
        transforms.Pad()
    with pytest.raises(KeyError, match="NoSuchTransform"):
        transforms.Compose([dict(type="NoSuchTransform")])


def test_collate_matches_jax():
    rng = np.random.RandomState(2)
    samples = []
    for i, (h, w) in enumerate([(64, 96), (96, 64), (80, 80)]):
        tgt = dict(rboxes=_rboxes(rng, 5 + i, 64),
                   hboxes=rng.rand(5 + i, 4).astype(np.float32),
                   polys=rng.rand(5 + i, 8).astype(np.float32),
                   labels=rng.randint(1, 10, 5 + i), scale_factor=0.5 * i)
        samples.append((rng.rand(h, w, 3).astype(np.float32), tgt))
    samples.append((np.zeros((64, 64, 3), np.float32), None))
    got = collate.collate_batch(samples, max_gt=6)
    ref = jcollate.collate_batch(samples, max_gt=6)
    np.testing.assert_array_equal(got[0], ref[0])
    assert sorted(got[1]) == sorted(ref[1])
    for k in ref[1]:
        np.testing.assert_array_equal(got[1][k], ref[1][k])


def _write_tiles(root, names, size, seed):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        Image.fromarray(rng.randint(0, 256, (size, size, 3)).astype(
            np.uint8)).save(os.path.join(root, name))
    return root


def test_load_rgb_matches_pil(tmp_path):
    root = _write_tiles(str(tmp_path), ["a.png"], 33, 3)
    path = os.path.join(root, "a.png")
    np.testing.assert_array_equal(
        load_rgb_array(path),
        np.asarray(Image.open(path).convert("RGB"), np.uint8))


@pytest.mark.parametrize("flip_mode", [None, "H", "V", "HV"])
def test_image_dataset_batches_match_jax(tmp_path, flip_mode):
    """Batch 3 over 4 tiles: the last batch is padded with a zero image
    and a None meta; flips are of the normalized image."""
    names = [f"P{k}__1.0__{x}___0.png" for k in range(2) for x in (0, 48)]
    root = _write_tiles(str(tmp_path), names, 64, 4)
    kw = dict(images_dir=root, dataset_type="FAIR1M_1_5", batch_size=3,
              transforms=[dict(type="RotatedResize", min_size=64,
                               max_size=64), dict(type="Pad", size_divisor=32),
                          NORM])
    got = list(ImageDataset(**kw).batches(flip_mode))
    ref = list(JImageDataset(**kw).batches(flip_mode))
    assert len(got) == len(ref) == 2
    for (gi, gt, gm), (ri, rt, rm) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        for k in rt:
            np.testing.assert_array_equal(gt[k], rt[k])
        assert gm == rm
    assert got[1][2][1:] == [None, None]
    assert got[0][2][0]["flip_mode" if flip_mode else "filename"] == (
        flip_mode or names[0])


def _dets(rng, n, span=300.0):
    """Seeded rotated rectangles as [n, 9] polygon + score: groups of
    four jittered copies of one box (centre +-3 px, sides +-10%, angle
    +-0.1), so that IoUs spread over (0, 1)."""
    r = np.repeat(_rboxes(rng, n // 4 + 1, span), 4, 0)[:n]
    r[:, :2] += rng.uniform(-3, 3, (n, 2))
    r[:, 2:4] *= rng.uniform(0.9, 1.1, (n, 2))
    r[:, 4] += rng.uniform(-0.1, 0.1, n)
    return np.concatenate([box_ops.rotated_box_to_poly_np(r),
                           rng.rand(n, 1)], 1).astype(np.float64)


@pytest.mark.parametrize("thresh", [0.0001, 0.1, 0.3, 0.6])
def test_poly_nms_core_numpy_and_jax_agree(thresh):
    rng = np.random.RandomState(int(thresh * 1e4))
    dets = _dets(rng, 400)
    keep = nms_poly.poly_nms_numpy(dets, thresh)
    assert 1 < len(keep) < len(dets)
    np.testing.assert_array_equal(nms_poly.poly_nms(dets, thresh), keep)
    np.testing.assert_array_equal(jnms_poly.poly_nms_numpy(dets, thresh),
                                  keep)
    assert nms_poly.poly_nms(np.zeros((0, 9)), thresh).shape == (0,)


def test_poly_iou_matches_jax():
    rng = np.random.RandomState(6)
    dets = _dets(rng, 40)
    q = dets[0, :8]
    np.testing.assert_array_equal(nms_poly.iou_polys_np(q, dets[:, :8]),
                                  jnms_poly.iou_polys_np(q, dets[:, :8]))
    assert nms_poly.iou_poly_single(q, q) == pytest.approx(1.0)
    assert nms_poly.iou_poly_single(q, dets[1, :8]) == \
        jnms_poly.iou_poly_single(q, dets[1, :8])


def _results_pickle(path, seed=7):
    """A results pickle as ``Runner.test`` writes it: 2 scenes x 2 tile
    offsets x the four flip modes, overlapping detections of 10
    classes."""
    rng = np.random.RandomState(seed)
    results = []
    for mode in (None, "H", "V", "HV"):
        for k in range(2):
            for x, y in ((0, 0), (200, 100)):
                n = 120
                dets = _dets(rng, n, 256.0)
                meta = dict(img_file=f"/tiles/P{k:04d}__1.0__{x}___{y}.png",
                            ori_img_size=(256, 256), scale_factor=1.0)
                if mode:
                    meta["flip_mode"] = mode
                results.append(((dets[:, :8].astype(np.float32),
                                 dets[:, 8].astype(np.float32),
                                 rng.randint(1, 11, n)), meta))
    with open(path, "wb") as f:
        pickle.dump(results, f)
    return path


def _tree(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            if f.endswith(".zip"):
                with zipfile.ZipFile(p) as z:
                    out[os.path.relpath(p, root)] = {
                        n: z.read(n) for n in sorted(z.namelist())}
            else:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("dataset_type,nms_type", [
    ("DOTA", 0), ("FAIR1M_1_5", 1), ("FAIR1M_1_5", 0), ("FAIR", 0)])
def test_merge_and_submission_match_jax(tmp_path, monkeypatch, dataset_type,
                                        nms_type):
    """The same pickle through both pipelines (the port's spawned class
    workers, the JAX one in-process): the before/after-NMS files, the
    FAIR XML files and the submission zip members or CSV byte for
    byte."""
    pkl = _results_pickle(str(tmp_path / "test_0.pkl"))
    monkeypatch.setattr(jdata_merge, "mergebypoly",
                        partial(jresult_merge.mergebypoly, num_process=1))
    trees = []
    for name, fn in (("port", data_merge.data_merge_result),
                     ("jax", jdata_merge.data_merge_result)):
        root = tmp_path / name
        root.mkdir()
        monkeypatch.chdir(root)
        out = fn(pkl, str(root / "work"), 0, "sub", dataset_type=dataset_type,
                 nms_threshold_type=nms_type)
        assert os.path.exists(out)
        trees.append(_tree(str(root)))
    assert trees[0] == trees[1]
    after = [k for k in trees[0] if "after_nms" in k]
    before = [k for k in trees[0] if "before_nms" in k]
    n_after = sum(trees[0][k].count(b"\n") for k in after)
    n_before = sum(trees[0][k].count(b"\n") for k in before)
    assert len(after) == len(before) == 10  # labels 1-10
    assert 0 < n_after < n_before


def test_mergebypoly_serial_equals_parallel(tmp_path):
    pkl = _results_pickle(str(tmp_path / "test_0.pkl"), seed=8)
    data_merge.prepare_data(pkl, str(tmp_path / "before"),
                            data_merge.get_classes_by_name("FAIR1M_1_5"))
    for n in (1, 4):
        result_merge.mergebypoly(str(tmp_path / "before"),
                                 str(tmp_path / f"after{n}"),
                                 nms_threshold_type=1, num_process=n)
    assert _tree(str(tmp_path / "after1")) == _tree(str(tmp_path / "after4"))


def test_tile_name_parse_matches_jax():
    for name in ("P0003__1.0__824___0", "S1__0.5__0___1648",
                 "img_x__1.5__12___34"):
        assert result_merge.parse_tile_name(name) == \
            jresult_merge.parse_tile_name(name)
