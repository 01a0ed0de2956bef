"""The port's host-side training data against the JAX package:
``rotated_box_to_bbox_np``, each training transform over several seeds
(Python's ``random`` and ``np.random`` seeded alike on both sides),
``voc_ap`` / ``voc_eval_dota`` with difficult ground truths, the
labelled datasets' seeded batches (``CustomDataset``, ``DOTADataset``
with its class balancing, ``FAIR1M_1_5_Dataset``; empty tiles resampled)
and ``DOTADataset.evaluate`` / ``parse_result``. CPU, numpy only."""

import os
import pickle
import random

import numpy as np
import pytest
from PIL import Image

from rs_detection_tpu.data import dota as jdota
from rs_detection_tpu.data import transforms as jtransforms
from rs_detection_tpu.data.custom import CustomDataset as JCustomDataset
from rs_detection_tpu.data.devkits import voc_eval as jvoc_eval
from rs_detection_tpu.ops import box_ops as jbox
from rs_detection_tpu_torch.data import dota, transforms
from rs_detection_tpu_torch.data.custom import CustomDataset
from rs_detection_tpu_torch.data.devkits import voc_eval
from rs_detection_tpu_torch.ops import box_ops

NORM = dict(type="Normalize", mean=[123.675, 116.28, 103.53],
            std=[58.395, 57.12, 57.375], to_bgr=False)
SEEDS = [0, 1, 2, 5]


def _rboxes(rng, n, size):
    return np.stack([rng.uniform(8, size - 8, n), rng.uniform(8, size - 8, n),
                     rng.uniform(4, 40, n), rng.uniform(4, 20, n),
                     rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)],
                    1).astype(np.float32)


def _seed(seed):
    random.seed(seed)
    np.random.seed(seed)


@pytest.mark.parametrize("n", [0, 1, 37])
def test_rotated_box_to_bbox_matches_jax(n):
    r = _rboxes(np.random.RandomState(n), n, 200)
    got, ref = box_ops.rotated_box_to_bbox_np(r), jbox.rotated_box_to_bbox_np(r)
    for g, e in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == e.shape
        np.testing.assert_array_equal(g, e)


TRAIN_TRANSFORMS = {
    "flip_h": dict(type="RandomFlip", prob=0.5),
    "flip_v": dict(type="RandomFlip", prob=0.5, direction="vertical"),
    "flip_hv": dict(type="RandomFlip", prob=0.7, direction="diagonal"),
    "rflip_h": dict(type="RotatedRandomFlip", prob=0.5),
    "rflip_v": dict(type="RotatedRandomFlip", prob=0.5,
                    direction="vertical"),
    "rotate": dict(type="RandomRotateAug", random_rotate_on=True),
    "noise": dict(type="RandmNoise", prob=0.6, max_noise=20.0),
    "gray": dict(type="RandmGrayScale", prob=0.5),
}


def _sample(rng, w=96, h=64):
    img = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    r = _rboxes(rng, 9, min(w, h))
    hb, polys = box_ops.rotated_box_to_bbox_np(r)
    target = dict(img_size=img.size, rboxes=r, hboxes=hb, polys=polys,
                  rboxes_ignore=r[:2].copy(), hboxes_ignore=hb[:2].copy(),
                  polys_ignore=polys[:2].copy(),
                  labels=rng.randint(1, 10, 9))
    return img, target


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(TRAIN_TRANSFORMS))
def test_training_transform_matches_jax(name, seed):
    """A random transform, then two more calls of it (so the draws of
    one call do not hide a wrong order in the next), from the same
    seeds: equal image bytes, boxes within 1e-4, the same keys and the
    same draws left over."""
    cfg = TRAIN_TRANSFORMS[name]
    got_t, ref_t = (transforms.Compose([cfg] * 3),
                    jtransforms.Compose([cfg] * 3))
    img, target = _sample(np.random.RandomState(100 + seed))
    _seed(seed)
    got_img, got = got_t(img, {k: np.copy(v) if isinstance(v, np.ndarray)
                               else v for k, v in target.items()})
    got_next = (random.random(), np.random.rand())
    _seed(seed)
    ref_img, ref = ref_t(img, {k: np.copy(v) if isinstance(v, np.ndarray)
                               else v for k, v in target.items()})
    assert got_next == (random.random(), np.random.rand())
    assert got_img.size == ref_img.size
    assert got_img.tobytes() == ref_img.tobytes()
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v))


def test_transform_pipeline_changes_something():
    """Over the seeds the flips and rotations do act (the parity above
    is not of identities)."""
    img, target = _sample(np.random.RandomState(3))
    seen = set()
    for seed in range(8):
        _seed(seed)
        _, t = transforms.Compose([TRAIN_TRANSFORMS["rflip_h"],
                                   TRAIN_TRANSFORMS["rotate"]])(
            img, dict(target))
        seen.add((t.get("flip"), t["rotate_angle"]))
    assert len(seen) >= 4


def test_diagonal_rotated_flip_raises():
    img, target = _sample(np.random.RandomState(4))
    flip = transforms.RotatedRandomFlip(prob=1.0, direction="diagonal")
    with pytest.raises(ValueError, match="diagonal"):
        flip(img, target)


def _voc_case(rng, n_img=4):
    """Detections around seeded ground truths (some exact, some jittered,
    some stray), with difficult ground truths in every image."""
    gts, dets = {}, []
    for i in range(n_img):
        r = _rboxes(rng, 6, 300)
        polys = box_ops.rotated_box_to_poly_np(r).astype(np.float64)
        diff = np.zeros(6, bool)
        diff[rng.randint(6)] = True
        gts[i] = {"box": polys, "det": [False] * 6, "difficult": diff}
        jit = r.copy()
        jit[:, :2] += rng.uniform(-4, 4, (6, 2))
        stray = _rboxes(rng, 3, 300)
        for p in (polys, box_ops.rotated_box_to_poly_np(jit),
                  box_ops.rotated_box_to_poly_np(stray)):
            dets.append(np.concatenate([np.full((len(p), 1), i), p,
                                        rng.rand(len(p), 1)], 1))
    return np.concatenate(dets), gts


def _copy_gts(gts):
    return {k: {"box": v["box"].copy(), "det": list(v["det"]),
                "difficult": v["difficult"].copy()} for k, v in gts.items()}


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_ap_matches_jax(use_07):
    rng = np.random.RandomState(9)
    rec = np.sort(rng.rand(50))
    prec = rng.rand(50)
    got = voc_eval.voc_ap(rec, prec, use_07)
    ref = jvoc_eval.voc_ap(rec, prec, use_07)
    assert abs(got - ref) <= 1e-12 and 0 < got < 1


@pytest.mark.parametrize("ovthresh", [0.3, 0.5, 0.7])
def test_voc_eval_dota_matches_jax(ovthresh):
    """Recall, precision and AP to 1e-12, and the same matched flags."""
    dets, gts = _voc_case(np.random.RandomState(int(ovthresh * 10)))
    g1, g2 = _copy_gts(gts), _copy_gts(gts)
    rec, prec, ap = voc_eval.voc_eval_dota(dets, g1, ovthresh=ovthresh)
    rrec, rprec, rap = jvoc_eval.voc_eval_dota(dets, g2, ovthresh=ovthresh)
    np.testing.assert_allclose(rec, rrec, atol=1e-12)
    np.testing.assert_allclose(prec, rprec, atol=1e-12)
    assert abs(ap - rap) <= 1e-12 and 0 < ap < 1
    assert all(g1[k]["det"] == g2[k]["det"] for k in g1)
    assert voc_eval.voc_eval_dota(dets[:0], _copy_gts(gts)) == (0.0, 0.0, 0.0)


def make_labelled(root, n=6, size=64, empty=(2,), seed=0, labels=None):
    """Seeded tiles and a ``labels.pkl`` as the JAX package's
    ``tests/test_runner.py:make_dataset`` makes them, with the tiles in
    ``empty`` left without boxes (drawn again when met) and an ignored
    box on each labelled tile."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.RandomState(seed)
    infos = []
    for i in range(n):
        name = f"tile_{i}.png"
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(
            np.uint8)).save(os.path.join(root, "images", name))
        boxes = np.array([[20 + i, 20, 24, 12, 0.3],
                          [40, 36 + i, 16, 8, -0.4]], np.float32)
        lab = np.array(labels[i] if labels else [1 + i % 10, 2], np.int64)
        if i in empty:
            boxes, lab = np.zeros((0, 5), np.float32), lab[:0]
        infos.append(dict(
            filename=name, width=size, height=size,
            ann=dict(bboxes=boxes, labels=lab,
                     bboxes_ignore=np.array([[10, 50, 8, 6, 0.1]],
                                            np.float32),
                     labels_ignore=np.zeros((0,), np.int64))))
    with open(os.path.join(root, "labels.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return root


def _assert_same_batches(got, ref):
    assert len(got) == len(ref) > 0
    for (gi, gt, gm), (ri, rt, rm) in zip(got, ref):
        np.testing.assert_array_equal(gi, ri)
        assert sorted(gt) == sorted(rt)
        for k in rt:
            np.testing.assert_array_equal(gt[k], rt[k])
        assert len(gm) == len(rm)
        for a, b in zip(gm, rm):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)


DATASET_CASES = {
    "custom": (CustomDataset, JCustomDataset, {}),
    "dota_balanced": (dota.DOTADataset, jdota.DOTADataset,
                      dict(balance_category=True)),
    "dota1_5": (dota.DOTADataset, jdota.DOTADataset, dict(version="1_5")),
    "fair1m_1_5": (dota.FAIR1M_1_5_Dataset, jdota.FAIR1M_1_5_Dataset, {}),
    "fair1m_1_5_balanced": (dota.FAIR1M_1_5_Dataset,
                            jdota.FAIR1M_1_5_Dataset,
                            dict(balance_category=True)),
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", sorted(DATASET_CASES))
def test_labelled_dataset_batches_match_jax(tmp_path, case, seed):
    """Shuffled batches of 4 (the last one short) through flips and
    rotations, empty tiles resampled, one seed on both sides: equal
    images, dense targets and metas. The DOTA labels hit classes of
    ``BALANCE_DICT`` (storage-tank x1 + 526, helicopter x8); FAIR1M-1.5
    has 10 classes, none of them there."""
    port, jax_cls, extra = DATASET_CASES[case]
    top = 10 if "fair" in case else 15
    labels = [[10, top], [1, 2], [3, 10], [top, 4], [5, 6], [10, 7]]
    root = make_labelled(str(tmp_path), labels=labels)
    kw = dict(dataset_dir=root, batch_size=4, shuffle=True, max_gt=4,
              filter_empty_gt=False, transforms=[
                  dict(type="RotatedResize", min_size=64, max_size=64),
                  dict(type="RotatedRandomFlip", prob=0.5),
                  dict(type="RandomRotateAug", random_rotate_on=True),
                  dict(type="Pad", size_divisor=32), NORM], **extra)
    got_ds, ref_ds = port(**kw), jax_cls(**kw)
    assert len(got_ds) == len(ref_ds)
    assert got_ds.CLASSES == ref_ds.CLASSES
    _seed(seed)
    got = list(got_ds.batches(seed))
    _seed(seed)
    ref = list(ref_ds.batches(seed))
    _assert_same_batches(got, ref)
    if "balanced" in case:
        assert len(got_ds) > 6
    assert all(len(m["rboxes"]) > 0 for _, _, ms in got for m in ms)


def test_filter_and_drop_last_and_prefetch(tmp_path):
    """``filter_empty_gt`` and ``filter_min_size`` as in JAX;
    ``drop_last``; ``prefetch`` yields ``batches`` and, with workers,
    the same batches for transforms that draw nothing."""
    root = make_labelled(str(tmp_path), n=7, empty=(1, 4))
    kw = dict(dataset_dir=root, batch_size=2, max_gt=4, transforms=[NORM])
    assert len(CustomDataset(**kw)) == len(JCustomDataset(**kw)) == 5
    assert len(CustomDataset(filter_min_size=65, **kw)) == 0
    ds = CustomDataset(drop_last=True, **kw)
    assert len(list(ds.batches())) == 2
    ds = CustomDataset(**kw)
    _assert_same_batches(list(ds.prefetch()), list(ds.batches()))
    pooled = CustomDataset(num_workers=3, **kw)
    _assert_same_batches(list(pooled.prefetch()), list(ds.batches()))
    pooled.close()
    pooled.close()


def test_prefetch_raises_what_the_thread_raised(tmp_path):
    """A failing transform ends the epoch with its error, not with a
    short epoch; an abandoned prefetch stops its thread."""
    root = make_labelled(str(tmp_path), n=4, empty=())

    def broken(image, target):
        raise RuntimeError("broken transform")

    ds = CustomDataset(dataset_dir=root, batch_size=2, transforms=[broken])
    with pytest.raises(RuntimeError, match="broken transform"):
        list(ds.prefetch())
    ds = CustomDataset(dataset_dir=root, batch_size=1, transforms=[NORM])
    it = ds.prefetch()
    next(it)
    it.close()


def _eval_results(rng, ds_kw, root):
    """((polys, scores, labels), target) pairs of a val pass: jittered
    copies of the ground truths and stray boxes, over ``scale_factor``
    0.5 (a resized tile)."""
    ds = dota.FAIR1M_1_5_Dataset(**ds_kw)
    results = []
    for _, _, metas in ds.batches():
        for m in metas:
            m = dict(m, scale_factor=0.5)
            gt = m["polys"] / 0.5
            polys = np.concatenate([gt + rng.uniform(-1, 1, gt.shape),
                                    box_ops.rotated_box_to_poly_np(
                                        _rboxes(rng, 3, 128))])
            labels = np.concatenate([m["labels"], rng.randint(1, 11, 3)])
            results.append(((polys.astype(np.float32),
                             rng.rand(len(labels)).astype(np.float32),
                             labels), m))
    return results


def test_evaluate_matches_jax(tmp_path):
    """The AP dict of one set of results: 10 classes and the mean,
    equal to 1e-12; the results pickle is written as in JAX."""
    root = make_labelled(str(tmp_path / "ds"), n=6, empty=())
    kw = dict(dataset_dir=root, batch_size=4, transforms=[NORM])
    results = _eval_results(np.random.RandomState(11), kw, root)
    got = dota.FAIR1M_1_5_Dataset(**kw).evaluate(
        results, str(tmp_path / "port"), 3)
    ref = jdota.FAIR1M_1_5_Dataset(**kw).evaluate(
        results, str(tmp_path / "jax"), 3)
    assert list(got) == list(ref) and len(got) == 11
    for k, v in ref.items():
        assert abs(got[k] - v) <= 1e-12, k
    assert got["eval/0_meanAP"] > 0
    assert (tmp_path / "port" / "detections" / "val_3" / "val.pkl").exists()
    empty = [((np.zeros((0, 8)), np.zeros(0), np.zeros(0, int)), m)
             for _, m in results]
    assert dota.FAIR1M_1_5_Dataset(**kw).evaluate(empty, None, 0) == \
        jdota.FAIR1M_1_5_Dataset(**kw).evaluate(empty, None, 0)


def test_parse_result_and_s2anet_post_match_jax(tmp_path):
    rng = np.random.RandomState(12)
    root = make_labelled(str(tmp_path / "ds"), n=2, empty=())
    results = [((np.concatenate([_rboxes(rng, 5, 100), rng.rand(5, 1)], 1),
                 rng.randint(0, 15, 5)), f"P{i}.png") for i in range(3)]
    kw = dict(dataset_dir=root)
    dota.DOTADataset(**kw).parse_result(results, str(tmp_path / "port"))
    jdota.DOTADataset(**kw).parse_result(results, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and names
    for n in names:
        assert (tmp_path / "port" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes()
    (dets, labels), _ = results[0]
    for g, e in zip(dota.s2anet_post((dets, labels)),
                    jdota.s2anet_post((dets, labels))):
        np.testing.assert_array_equal(g, e)
