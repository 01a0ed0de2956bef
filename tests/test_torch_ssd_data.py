"""SSD's data side in the port against the JAX package, CPU: the numpy
twins of the OpenCV calls (``data/cv_ops.py``) against cv2 (bit for bit,
or within one grey level where OpenCV's vector code and its scalar
remainder round differently); the four SSD transforms, then ``data/yolo.py``'s letterbox, mosaic-4 and
-9, random perspective (affine and projective), mixup, cutout, HSV and
flip paths, and ``COCODataset``'s samples, ``batches`` and ``evaluate``,
each against the JAX module under one seed (the same images, boxes and
labels; the pixels within one grey level). The JAX ``COCODataset`` is given the attributes its
``__init__`` never sets; its faults are pinned: the missing ``stride``,
the zoo's ``anno_file`` / ``root`` keys, and ``batches`` taking no
``flip_mode``."""

import json
import os
import pickle
import random
import subprocess
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

import rs_detection_tpu.data.transforms as jtransforms
import rs_detection_tpu.runner.runner  # noqa: F401  (the JAX datasets)
from rs_detection_tpu.data import yolo as jyolo
from rs_detection_tpu.utils.registry import DATASETS as JDATASETS
from rs_detection_tpu.utils.registry import TRANSFORMS as JTRANSFORMS
from rs_detection_tpu_torch.data import cv_ops
from rs_detection_tpu_torch.data import transforms
from rs_detection_tpu_torch.data import yolo
from rs_detection_tpu_torch.runner import runner  # noqa: F401  (datasets)
from rs_detection_tpu_torch.utils.registry import DATASETS, TRANSFORMS
from test_torch_ssd_cuda import render_coco

ZOO_TRAIN = [
    dict(type="PhotoMetricDistortion", brightness_delta=32 / 255,
         contrast_range=[0.5, 1.5], hue_delta=0.05,
         saturation_range=[0.5, 1.5]),
    dict(type="Expand", mean=[123.675, 116.28, 103.53], ratio_range=[1, 4]),
    dict(type="MinIoURandomCrop", min_crop_size=0.3,
         min_ious=[0.1, 0.3, 0.5, 0.7, 0.9]),
    dict(type="Resize_keep_ratio", keep_ratio=False, max_size=300,
         min_size=300),
    dict(type="RandomFlip", prob=0.5)]
PERSPECTIVE = dict(degrees=10, translate=0.1, scale=0.1, shear=10,
                   perspective=0.0)
SIZES = [(70, 90), (64, 64), (100, 60), (45, 80), (90, 90), (30, 70)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def within_one_grey_level(got, want):
    """uint8 images, or float images of uint8 levels over 255, of one
    dtype and shape and at most one level apart."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    scale = 255.0 if want.dtype.kind == "f" else 1.0
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max(initial=0) * scale <= 1 + 1e-3


def seeded(seed, fn):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def test_cv_ops_match_cv2_bit_for_bit():
    """On seeded uint8 images of odd sizes (vector remainders on every
    row): ``RGB2HSV`` on every 8-bit colour, ``resize`` up and down,
    ``copyMakeBorder`` and ``getRotationMatrix2D`` equal; ``HSV2RGB`` on
    every 8-bit HSV and ``warpAffine`` / ``warpPerspective`` with the
    YOLO warp's matrices into odd output sizes within one grey level."""
    every = np.resize(np.stack(np.meshgrid(
        np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
        -1).astype(np.uint8), (67109, 250, 3))
    assert np.array_equal(cv_ops.rgb2hsv(every),
                          cv2.cvtColor(every, cv2.COLOR_RGB2HSV))
    hsv = every.copy()
    hsv[..., 0] %= 180
    within_one_grey_level(cv_ops.hsv2rgb(hsv),
                          cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    rng = np.random.RandomState(0)
    for t in range(12):
        h, w = rng.randint(17, 150, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        dw, dh = (int(v) for v in rng.randint(5, 200, 2))
        assert np.array_equal(
            cv_ops.resize_linear(img, (dw, dh)),
            cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR))
        assert np.array_equal(
            cv_ops.copy_make_border(img, 1, 2, 3, 4, (114, 114, 114)),
            cv2.copyMakeBorder(img, 1, 2, 3, 4, cv2.BORDER_CONSTANT,
                               value=(114, 114, 114)))
        a, s = rng.uniform(-10, 10), rng.uniform(0.9, 1.1)
        r = np.eye(3)
        r[:2] = cv_ops.rotation_matrix_2d((0, 0), a, s)
        assert np.array_equal(r[:2], cv2.getRotationMatrix2D(
            angle=a, center=(0, 0), scale=s))
        c = np.eye(3)
        c[:2, 2] = -w / 2, -h / 2
        sh = np.eye(3)
        sh[0, 1], sh[1, 0] = np.tan(rng.uniform(-0.17, 0.17, 2))
        p = np.eye(3)
        p[2, :2] = rng.uniform(-1e-3, 1e-3, 2)
        tr = np.eye(3)
        tr[:2, 2] = rng.uniform(0.4, 0.6, 2) * (w, h)
        m = tr @ sh @ r @ c
        within_one_grey_level(
            cv_ops.warp_affine(img, m[:2], (dw, dh)),
            cv2.warpAffine(img, m[:2], dsize=(dw, dh),
                           borderValue=(114, 114, 114)))
        mp = tr @ sh @ r @ p @ c
        within_one_grey_level(
            cv_ops.warp_perspective(img, mp, (dw, dh)),
            cv2.warpPerspective(img, mp, dsize=(dw, dh),
                                borderValue=(114, 114, 114)))


def test_transform_registries_hold_the_same_names():
    assert sorted(TRANSFORMS.modules) == sorted(JTRANSFORMS.modules)


def _sample(rng, w=90, h=70, n=4):
    img = Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
    x1, y1 = rng.uniform(0, w - 30, n), rng.uniform(0, h - 30, n)
    hb = np.stack([x1, y1, x1 + rng.uniform(8, 30, n),
                   y1 + rng.uniform(8, 30, n)], 1).astype(np.float32)
    return img, dict(hboxes=hb, bboxes=hb.copy(),
                     labels=np.arange(1, n + 1), img_size=img.size)


def _same(got, ref):
    (gi, gt), (ri, rt) = got, ref
    within_one_grey_level(np.asarray(gi), np.asarray(ri))
    assert sorted(gt) == sorted(rt)
    for k in rt:
        np.testing.assert_array_equal(np.asarray(gt[k]), np.asarray(rt[k]))


@pytest.mark.parametrize("name", ["PhotoMetricDistortion", "Expand",
                                  "MinIoURandomCrop", "Resize_keep_ratio"])
def test_ssd_transforms_match_jax_under_one_seed(name):
    """Each of the zoo's SSD transforms, as the zoo configures it, on 12
    seeds (every branch of its draws), and the zoo's train pipeline as a
    whole: the same image and target as JAX's. ``Resize_keep_ratio``
    keeps the aspect whatever the config says, as in JAX."""
    cfg = next(c for c in ZOO_TRAIN if c["type"] == name)
    port = transforms.Compose([cfg])
    ref = jtransforms.Compose([dict(cfg)])
    for seed in range(12):
        got = seeded(seed, lambda: port(*_sample(np.random.RandomState(
            seed))))
        want = seeded(seed, lambda: ref(*_sample(np.random.RandomState(
            seed))))
        _same(got, want)
    if name == "Resize_keep_ratio":
        assert port.transforms[0].keep_ratio is True
    pipe, jpipe = transforms.Compose(ZOO_TRAIN), jtransforms.Compose(
        [dict(c) for c in ZOO_TRAIN])
    for seed in range(4):
        _same(seeded(seed, lambda: pipe(*_sample(np.random.RandomState(
            seed)))), seeded(seed, lambda: jpipe(*_sample(
                np.random.RandomState(seed)))))


def render_labelled(root, sizes=SIZES, seed=0):
    """A ``labels.pkl`` dataset of seeded images of ``sizes`` (w, h) with
    3 hbbs each (labels 1-3); the last image's boxes as rboxes."""
    os.makedirs(os.path.join(root, "images"))
    rng = np.random.RandomState(seed)
    infos = []
    for i, (w, h) in enumerate(sizes):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        name = f"im{i}.png"
        Image.fromarray(img).save(os.path.join(root, "images", name))
        x1, y1 = rng.uniform(0, w * 0.6, 3), rng.uniform(0, h * 0.6, 3)
        bw, bh = rng.uniform(6, w * 0.4, 3), rng.uniform(6, h * 0.4, 3)
        if i == len(sizes) - 1:
            ann = dict(bboxes=np.stack([x1 + bw / 2, y1 + bh / 2, bw, bh,
                                        rng.uniform(-1, 1, 3)], 1))
        else:
            ann = dict(hboxes=np.stack([x1, y1, x1 + bw, y1 + bh], 1))
        ann["labels"] = rng.randint(1, 4, 3)
        infos.append(dict(filename=name, width=w, height=h, ann=ann))
    with open(os.path.join(root, "labels.pkl"), "wb") as f:
        pickle.dump(infos, f)
    return root


@pytest.fixture(scope="module")
def labelled(tmp_path_factory):
    return render_labelled(str(tmp_path_factory.mktemp("yolo")))


PATHS = {
    "letterbox": dict(mosaic=False, hsv=False, flip=False),
    "letterbox_hsv_flip": dict(mosaic=False),
    "perspective": dict(mosaic=False, random_perspective=PERSPECTIVE),
    "projective": dict(mosaic=False, random_perspective=dict(
        PERSPECTIVE, perspective=5e-4)),
    "mosaic4": dict(),
    "mosaic4_perspective": dict(random_perspective=dict(
        type="YoloRandomPerspective", **PERSPECTIVE)),
    "mosaic9": dict(mosaic9_prob=1.0),
    "mixup": dict(mixup_prob=1.0),
    "cutout": dict(cutout_prob=1.0),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_yolo_dataset_matches_jax_under_one_seed(labelled, path):
    """``YoloDataset`` at 64^2 on every image, each under its own seed,
    with the path's options: the same boxes and labels as JAX's, and its
    uint8-derived image in [0, 1] within one grey level. The port's
    target also records the letterbox (``letterbox``), which JAX's does
    not."""
    kw = dict(dataset_dir=labelled, img_size=64, **PATHS[path])
    port, ref = yolo.YoloDataset(**kw), jyolo.YoloDataset(**kw)
    kept = 0
    for i in range(len(SIZES)):
        gi, gt = seeded(100 + i, lambda: port[i])
        ri, rt = seeded(100 + i, lambda: ref[i])
        assert gi.dtype == ri.dtype == np.float32
        within_one_grey_level(gi, ri)
        assert sorted(set(gt) - {"letterbox"}) == sorted(rt)
        for k in rt:
            np.testing.assert_array_equal(np.asarray(gt[k]),
                                          np.asarray(rt[k]))
        kept += len(gt["hboxes"])
    assert kept > 0


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coco"))
    img_dir, ann = render_coco(root, n=5, size=96, seed=3, objects=4)
    # one image not square, so that the letterbox resizes and pads
    big = Image.open(os.path.join(img_dir, "img_001.png")).resize((120, 80))
    big.save(os.path.join(img_dir, "img_001.png"))
    with open(ann) as f:
        data = json.load(f)
    data["images"][1].update(width=120, height=80)
    with open(ann, "w") as f:
        json.dump(data, f)
    return img_dir, ann


@pytest.fixture
def jax_coco_attrs(monkeypatch):
    """The five attributes ``YoloDataset.__init__`` sets and the JAX
    ``COCODataset.__init__`` never does (the port's values)."""
    for k, v in dict(stride=32, random_perspective=None, mixup_prob=0.0,
                     mosaic9_prob=0.0, cutout_prob=0.0).items():
        monkeypatch.setattr(jyolo.COCODataset, k, v, raising=False)


@pytest.mark.parametrize("opts", [dict(), dict(hsv=True, flip=True),
                                  dict(mosaic=True)],
                         ids=["plain", "hsv_flip", "mosaic"])
def test_coco_dataset_samples_and_batches_match_jax(coco, jax_coco_attrs,
                                                    opts):
    """``COCODataset`` at 64^2 (labels 1..K from the sorted category
    ids, the crowd box dropped): every sample under its seed, and the
    shuffled ``batches`` of 2 (the last short) with their 8 slots, equal
    to JAX's."""
    kw = dict(images_dir=coco[0], annotations_file=coco[1], img_size=64,
              batch_size=2, max_gt=8, shuffle=True, **opts)
    port, ref = yolo.COCODataset(**kw), jyolo.COCODataset(**kw)
    assert len(port) == len(ref) == 5
    for i in range(5):
        np.testing.assert_array_equal(port.img_infos[i]["ann"]["hboxes"],
                                      ref.img_infos[i]["ann"]["hboxes"])
        g, r = seeded(i, lambda: port[i]), seeded(i, lambda: ref[i])
        within_one_grey_level(g[0], r[0])
        for k in r[1]:
            np.testing.assert_array_equal(np.asarray(g[1][k]),
                                          np.asarray(r[1][k]))
    got = seeded(7, lambda: list(port.batches(seed=7)))
    want = seeded(7, lambda: list(ref.batches(seed=7)))
    assert [len(b[2]) for b in got] == [2, 2, 1]
    for (gi, gt, _), (ri, rt, _) in zip(got, want):
        within_one_grey_level(gi, ri)
        for k in rt:
            np.testing.assert_array_equal(gt[k], rt[k])


def letterboxed(sizes, img_size):
    """Where a ``letterbox(auto=False)`` puts an image of each (w, h):
    (r, dw, dh)."""
    out = []
    for w, h in sizes:
        r = min(img_size / h, img_size / w)
        out.append((r, (img_size - int(round(w * r))) / 2,
                    (img_size - int(round(h * r))) / 2))
    return out


def test_letterboxed_samples_record_their_frame(labelled):
    """A letterboxed ``YoloDataset`` sample of each non-square image
    records (r, dw, dh) in ``letterbox``: its boxes are the annotation's
    times r plus (dw, dh), and undone they are the annotation's again.
    A sample whose frame is not one letterbox (mosaic, perspective,
    flip) records none."""
    ds = yolo.YoloDataset(dataset_dir=labelled, img_size=64, mosaic=False,
                          hsv=False, flip=False)
    for i, want in enumerate(letterboxed(SIZES[:-1], 64)):
        img, t = seeded(i, lambda: ds[i])
        assert img.shape == (64, 64, 3)
        assert t["letterbox"] == pytest.approx(want)
        r, dw, dh = t["letterbox"]
        ann = ds.img_infos[i]["ann"]["hboxes"]
        np.testing.assert_allclose(t["hboxes"], ann * r + [dw, dh] * 2,
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose((t["hboxes"] - [dw, dh] * 2) / r, ann,
                                   rtol=1e-6, atol=1e-4)
    for opts in (dict(mosaic=True), dict(random_perspective=PERSPECTIVE),
                 dict(flip=True)):
        ds = yolo.YoloDataset(dataset_dir=labelled, img_size=64,
                              **dict(dict(mosaic=False, hsv=False,
                                          flip=False), **opts))
        unframed = sum("letterbox" not in seeded(i, lambda: ds[i])[1]
                       for i in range(len(SIZES)))
        if "flip" in opts:
            assert 0 < unframed < len(SIZES)
        else:
            assert unframed == len(SIZES)


def test_coco_evaluate_matches_jax(coco):
    """``COCODataset.evaluate`` on the same per-image results (the ground
    truth jittered, dropped, relabelled and joined by false positives),
    the port's as the runner's (polygons, scores, labels) and meta pairs,
    JAX's as the hbbs it reads: the same mAP, AP50 and per-class AP50."""
    port = yolo.COCODataset(images_dir=coco[0], annotations_file=coco[1])
    ref = jyolo.COCODataset(images_dir=coco[0], annotations_file=coco[1])
    rng = np.random.RandomState(4)
    results = []
    for info in port.img_infos:
        b = info["ann"]["hboxes"] + rng.uniform(-4, 4, (len(
            info["ann"]["hboxes"]), 4))
        lab = info["ann"]["labels"].copy()
        lab[rng.rand(len(lab)) < 0.2] = 1
        fp = rng.uniform(0, 60, (3, 2))
        b = np.concatenate([b, np.concatenate([fp, fp + 20], 1)])[1:]
        lab = np.concatenate([lab, [1, 2, 3]])[1:]
        results.append((b, rng.rand(len(b)), lab))
    pairs = [((b[:, [0, 1, 2, 1, 2, 3, 0, 3]], s, lab), {})
             for b, s, lab in results]
    got, want = port.evaluate(pairs), ref.evaluate(results)
    assert got == want
    assert 0 < got["eval/mAP"] < got["eval/AP50"] < 1


def test_jax_coco_dataset_faults_are_pinned(coco, tmp_path):
    """The JAX ``COCODataset``: ``__getitem__`` raises for the ``stride``
    its ``__init__`` never sets (the port sets it); the zoo's
    ``anno_file`` / ``root`` reach neither class, which open
    ``annotations_file`` None; its ``batches`` takes no ``flip_mode``,
    which the port takes as None for the runner's test task (and
    refuses a flip). ``LVISDataset`` waits for item 11f in the port."""
    kw = dict(images_dir=coco[0], annotations_file=coco[1], img_size=64)
    with pytest.raises(AttributeError, match="stride"):
        jyolo.COCODataset(**kw)[0]
    assert yolo.COCODataset(**kw)[0][0].shape == (64, 64, 3)
    zoo = dict(type="COCODataset", anno_file=coco[1], root=coco[0],
               batch_size=1)
    for registry in (DATASETS, JDATASETS):
        with pytest.raises(TypeError):
            registry.get("COCODataset")(**{k: v for k, v in zoo.items()
                                           if k != "type"})
    with pytest.raises(TypeError, match="flip_mode"):
        next(jyolo.COCODataset(**kw).batches(flip_mode=None))
    port = yolo.COCODataset(**kw)
    assert len(next(port.batches(flip_mode=None))[2]) == 5
    with pytest.raises(ValueError, match="flip"):
        next(port.batches(flip_mode="H"))
    with pytest.raises(NotImplementedError, match="item 11f"):
        DATASETS.get("LVISDataset")(annotations_file=coco[1])
    assert sorted(DATASETS.modules) == sorted(JDATASETS.modules)


def test_the_yolo_data_path_needs_no_cv2_or_jax(coco):
    """With cv2 unimportable (the card's machine has none): a mosaic,
    HSV, flip, perspective, mixup and cutout sample of ``COCODataset``
    and the zoo's SSD train transforms run, and neither jax nor the JAX
    package is imported."""
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "import numpy as np\n"
        "from PIL import Image\n"
        "from rs_detection_tpu_torch.data import transforms, yolo\n"
        f"ds = yolo.COCODataset(images_dir={coco[0]!r}, "
        f"annotations_file={coco[1]!r}, img_size=64, mosaic=True, "
        "hsv=True, flip=True, mixup_prob=1.0, cutout_prob=1.0)\n"
        "ds.random_perspective = dict(degrees=10, translate=0.1, "
        "scale=0.1, shear=10, perspective=0.0)\n"
        "img, t = ds[0]\n"
        "assert img.shape == (64, 64, 3)\n"
        f"pipe = transforms.Compose({ZOO_TRAIN!r})\n"
        "im = Image.fromarray(np.full((50, 60, 3), 90, np.uint8))\n"
        "pipe(im, dict(hboxes=np.array([[5., 5., 30., 40.]], np.float32), "
        "labels=np.array([1]), img_size=im.size))\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'flax', 'rs_detection_tpu')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
