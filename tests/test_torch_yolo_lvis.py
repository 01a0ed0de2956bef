"""``LVISDataset`` in the port against the JAX package, CPU: the port's
copy of the 1203-category LVIS v1 table equals JAX's; a rendered LVIS v1
json (every category, file names from ``coco_url`` on some images,
``neg_category_ids``) reads to the same samples; ``evaluate`` drops an
image's detections of classes not evaluable there and gives the APr /
APc / APf split, equal to the JAX method's on the same detections (JAX
takes (boxes, scores, labels) an image, the port the runner's
(detections, meta) pairs); the JAX method raises on the runner's pairs
(quirk 7)."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from rs_detection_tpu.config import lvis_categories as jlvis
from rs_detection_tpu.data import yolo as jyolo
from rs_detection_tpu_torch.config import lvis_categories as lvis
from rs_detection_tpu_torch.data import yolo  # noqa: F401  (LVISDataset)
from rs_detection_tpu_torch.utils import registry as reg
from torch_one_thread import _one_thread  # noqa: F401

IMG = 64


def render_lvis(root):
    """3 images of 64^2: image 0 a box of category 1 and ``neg_category_ids``
    [3], image 1 a box of 13, image 2 a box of 3 and one of 1; images 1
    and 2 name their files by ``coco_url`` only. Every LVIS v1 category
    in the json, so that labels equal category ids."""
    os.makedirs(root / "images")
    boxes = {0: [(1, [4, 4, 20, 30])], 1: [(13, [10, 12, 30, 20])],
             2: [(3, [5, 5, 40, 40]), (1, [30, 2, 20, 20])]}
    images, anns = [], []
    for i in range(3):
        name = f"img_{i}.png"
        Image.fromarray(np.full((IMG, IMG, 3), 40 * i, np.uint8)).save(
            root / "images" / name)
        im = dict(id=10 + i, width=IMG, height=IMG,
                  neg_category_ids=[3] if i == 0 else [],
                  not_exhaustive_category_ids=[])
        if i == 0:
            im["file_name"] = name
        else:
            im["coco_url"] = f"http://images.example/val2017/{name}"
        images.append(im)
        for cid, bbox in boxes[i]:
            anns.append(dict(id=len(anns) + 1, image_id=10 + i,
                             category_id=cid, bbox=bbox, iscrowd=0,
                             area=bbox[2] * bbox[3]))
    cats = [dict(id=k + 1, name=n, frequency=f)
            for k, (n, f) in enumerate(lvis.LVIS_V1_CATEGORIES)]
    path = root / "lvis_v1_val.json"
    with open(path, "w") as f:
        json.dump(dict(images=images, annotations=anns, categories=cats), f)
    return str(root / "images"), str(path)


def hbb_poly(b):
    x0, y0, x1, y1 = b
    return [x0, y0, x1, y0, x1, y1, x0, y1]


# per image (hbb, score, label): the ground truth at 0.9, and false
# detections of category 3 at 0.95 on image 0 (evaluable there: a
# negative) and at 0.99 on image 1 (not evaluable: dropped)
DETS = {0: [([4, 4, 24, 34], 0.9, 1), ([40, 40, 60, 60], 0.95, 3)],
        1: [([10, 12, 40, 32], 0.9, 13), ([2, 2, 12, 12], 0.99, 3)],
        2: [([5, 5, 45, 45], 0.9, 3), ([30, 2, 50, 22], 0.9, 1)]}


def test_the_table_equals_jax():
    assert lvis.LVIS_V1_CATEGORIES == jlvis.LVIS_V1_CATEGORIES
    assert lvis.LVIS_CLASSES == jlvis.LVIS_CLASSES
    assert len(lvis.LVIS_CLASSES) == 1203
    assert {f for _, f in lvis.LVIS_V1_CATEGORIES} == {"r", "c", "f"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    img_dir, ann = render_lvis(tmp_path_factory.mktemp("lvis"))
    kw = dict(images_dir=img_dir, annotations_file=ann, img_size=IMG)
    return reg.build_from_cfg(dict(type="LVISDataset", **kw), reg.DATASETS), \
        jyolo.LVISDataset(**kw)


def test_reads_like_jax(data):
    """The same image files (from ``coco_url`` where there is no
    ``file_name``), boxes and labels (the category ids), and the 1203
    classes; each image serves letterboxed."""
    port, ref = data
    assert len(port) == len(ref) == 3 and len(port.CLASSES) == 1203
    for a, b in zip(port.img_infos, ref.img_infos):
        assert a["filename"] == b["filename"]
        np.testing.assert_array_equal(a["ann"]["hboxes"], b["ann"]["hboxes"])
        np.testing.assert_array_equal(a["ann"]["labels"], b["ann"]["labels"])
    assert [i["filename"] for i in port.img_infos] == \
        ["img_0.png", "img_1.png", "img_2.png"]
    img, target = port[1]
    assert img.shape == (IMG, IMG, 3) and target["letterbox"] == (1.0, 0, 0)


def test_evaluate_filters_and_splits_like_jax(data):
    """``evaluate`` of the runner's pairs: category 3's false detection
    on image 1 (not annotated there, not a negative) is dropped, the one
    on image 0 (a negative there) counts, scored above category 3's true
    detection, so its AP50 is 0.5 (1 / 3 without the filter); 1 and 13
    score 1. APr, APc and APf are the means of the 1203 classes' AP50
    over the rare (13 among them), common (1) and frequent (3) ones.
    Every number equals the JAX method's on the same detections as
    (hbbs, scores, labels)."""
    port, ref = data
    pairs, triples = [], []
    for i in range(3):
        b = np.asarray([d[0] for d in DETS[i]], np.float32)
        s = np.asarray([d[1] for d in DETS[i]], np.float32)
        lab = np.asarray([d[2] for d in DETS[i]])
        pairs.append(((np.asarray([hbb_poly(x) for x in b], np.float32), s,
                       lab), dict(img_size=(IMG, IMG))))
        triples.append((b, s, lab))
    got = port.evaluate(pairs)
    want = ref.evaluate(triples)
    ap = got["per_class_ap50"]
    assert len(ap) == 1203
    assert (ap[0], ap[2], ap[12]) == (1.0, 0.5, 1.0)
    assert sum(ap) == 2.5
    freq = [f for _, f in lvis.LVIS_V1_CATEGORIES]
    for g, name in (("r", "APr"), ("c", "APc"), ("f", "APf")):
        assert got[f"eval/{name}"] == pytest.approx(np.mean(
            [a for a, f in zip(ap, freq) if f == g]), abs=1e-12)
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.allclose(got[k], v, rtol=0, atol=1e-12), k


def test_the_jax_method_cannot_take_the_runners_pairs(data):
    """Quirk 7: the JAX runner's ``val`` hands ``evaluate`` (detections,
    meta) pairs; the JAX ``LVISDataset.evaluate`` reads each result as
    three arrays (``b, s, l = (np.asarray(x) for x in res)``,
    ``rs_detection_tpu/data/yolo.py:603``) and raises on the pair's
    detections, as ``COCODataset.evaluate`` raises unpacking it."""
    _, ref = data
    det = (np.zeros((2, 8)), np.zeros(2), np.zeros(2, int))
    with pytest.raises(ValueError, match="inhomogeneous"):
        ref.evaluate([(det, {})])
