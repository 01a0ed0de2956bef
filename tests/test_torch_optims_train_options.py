"""Training options of the port that no config sets, against the JAX
package: the sampler's ``neg_pos_ub`` (a bound on negatives per
positive), ignore regions in ``MaxIoUAssigner`` (``ignore_iof_thr``)
and in ``anchor_target_single``, and every loss's ``reduction`` "none"
and "sum" beside the mean (with and without ``avg_factor``).

The samplers draw different numbers in the two frameworks, so the
sampled sets are held by their counts; assignments are exact; the
losses are f32 elementwise (1e-5 relative)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.models.boxes import anchor_target as janchor
from rs_detection_tpu.models.boxes import assigner as jassigner
from rs_detection_tpu.models.boxes import sampler as jsampler
from rs_detection_tpu_torch.models.boxes import anchor_target, assigner
from rs_detection_tpu_torch.models.boxes import sampler

# the modules (the packages export functions of the same names)
jcommon, jpoly, common, poly_iou_loss = (importlib.import_module(
    f"{pkg}.models.losses.{m}") for pkg in ("rs_detection_tpu",
                                            "rs_detection_tpu_torch")
    for m in ("common", "poly_iou_loss"))


def _assigned(seed, b=4, a=300, pos=(3, 40, 0, 12), neg=(200, 30, 150, 5)):
    """[B, A] -1 / 0 / k encodings with the given positive and negative
    counts an image."""
    rng = np.random.RandomState(seed)
    out = np.full((b, a), -1, np.int64)
    for i in range(b):
        idx = rng.permutation(a)
        out[i, idx[:pos[i]]] = rng.randint(1, 5, pos[i])
        out[i, idx[pos[i]:pos[i] + neg[i]]] = 0
    return out


@pytest.mark.parametrize("ub", [-1, 0, 1, 3])
def test_neg_pos_ub_counts_match_jax(ub):
    assigned = _assigned(ub + 2)
    kw = dict(num=64, pos_fraction=0.25, neg_pos_ub=ub)
    pos, neg = sampler.RandomSampler(**kw).sample(
        torch.from_numpy(assigned), torch.Generator().manual_seed(0))
    js = jsampler.RandomSampler(**kw)
    for i, row in enumerate(assigned):
        jp, jn = js.sample(jnp.asarray(row), jax.random.PRNGKey(i))
        assert int(pos[i].sum()) == int(jp.sum()), (ub, i)
        assert int(neg[i].sum()) == int(jn.sum()), (ub, i)
        assert bool((row[pos[i].numpy()] > 0).all())
        assert bool((row[neg[i].numpy()] == 0).all())


def _boxes(rng, n, rotated):
    ctr = rng.uniform(10, 90, (n, 2))
    wh = rng.uniform(6, 40, (n, 2))
    if rotated:
        return np.concatenate([ctr, wh, rng.uniform(-1.2, 1.2, (n, 1))],
                              1).astype(np.float32)
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


@pytest.mark.parametrize("rotated", [False, True])
def test_ignore_regions_assign_like_jax(rotated):
    """Two images, one without valid ignore boxes: every anchor covered by
    an ignore box beyond ``ignore_iof_thr`` becomes -1, as in JAX."""
    rng = np.random.RandomState(7 + rotated)
    anchors = _boxes(rng, 120, rotated)
    gts = np.stack([_boxes(rng, 5, rotated) for _ in range(2)])
    gt_mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool)
    ign = np.stack([_boxes(rng, 3, rotated) for _ in range(2)])
    ign_mask = np.array([[1, 1, 0], [0, 0, 0]], bool)
    cls_p, cls_j = ((assigner.MaxIoUAssignerRbbox,
                     jassigner.MaxIoUAssignerRbbox) if rotated else
                    (assigner.MaxIoUAssigner, jassigner.MaxIoUAssigner))
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.3,
              ignore_iof_thr=0.4)
    got, _ = cls_p(**kw).assign(
        torch.from_numpy(anchors), torch.from_numpy(gts),
        torch.from_numpy(gt_mask), gt_bboxes_ignore=torch.from_numpy(ign),
        gt_ignore_mask=torch.from_numpy(ign_mask))
    plain, _ = cls_p(**dict(kw, ignore_iof_thr=-1)).assign(
        torch.from_numpy(anchors), torch.from_numpy(gts),
        torch.from_numpy(gt_mask), gt_bboxes_ignore=torch.from_numpy(ign))
    for i in range(2):
        want, _ = cls_j(**kw).assign(
            jnp.asarray(anchors), jnp.asarray(gts[i]), jnp.asarray(gt_mask[i]),
            gt_bboxes_ignore=jnp.asarray(ign[i]),
            gt_ignore_mask=jnp.asarray(ign_mask[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    changed = (got != plain).sum(-1)
    assert changed[0] > 0 and changed[1] == 0


def test_anchor_target_ignore_regions_like_jax():
    """``anchor_target_single`` passes the ignore boxes to the assigner:
    labels, weights and counts of one image as JAX's."""
    rng = np.random.RandomState(3)
    anchors = _boxes(rng, 120, False)
    gts = _boxes(rng, 4, False)
    ign = _boxes(rng, 2, False)
    gt_mask = np.ones(4, bool)
    labels = np.array([1, 2, 3, 4], np.int32)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.3, ignore_iof_thr=0.5)
    enc = lambda a, g: g - a  # noqa: E731
    want = janchor.anchor_target_single(
        jnp.asarray(anchors), jnp.ones(120, bool), jnp.asarray(gts),
        jnp.asarray(gt_mask), jnp.asarray(labels),
        jassigner.MaxIoUAssigner(**kw), jsampler.PseudoSampler(), enc,
        gt_bboxes_ignore=jnp.asarray(ign),
        gt_ignore_mask=jnp.ones(2, bool))
    got = anchor_target.anchor_target_single(
        torch.from_numpy(anchors), torch.ones(120, dtype=torch.bool),
        torch.from_numpy(gts)[None], torch.from_numpy(gt_mask)[None],
        torch.from_numpy(labels)[None], assigner.MaxIoUAssigner(**kw),
        sampler.PseudoSampler(), enc, None,
        gt_bboxes_ignore=torch.from_numpy(ign)[None],
        gt_ignore_mask=torch.ones(1, 2, dtype=torch.bool))
    np.testing.assert_array_equal(got.labels[0].numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.label_weights[0].numpy(),
                                  np.asarray(want.label_weights))
    assert int(got.num_neg[0]) == int(want.num_neg)
    plain = anchor_target.anchor_target_single(
        torch.from_numpy(anchors), torch.ones(120, dtype=torch.bool),
        torch.from_numpy(gts)[None], torch.from_numpy(gt_mask)[None],
        torch.from_numpy(labels)[None],
        assigner.MaxIoUAssigner(**dict(kw, ignore_iof_thr=-1)),
        sampler.PseudoSampler(), enc, None,
        gt_bboxes_ignore=torch.from_numpy(ign)[None])
    assert int(plain.num_neg[0]) > int(got.num_neg[0])


def _loss_inputs(kind, rng, n=24):
    boxes = lambda: np.concatenate([  # noqa: E731
        rng.uniform(20, 80, (n, 2)), rng.uniform(8, 40, (n, 2)),
        rng.uniform(-1, 1, (n, 1))], 1).astype(np.float32)
    if kind == "cls":
        return (rng.randn(n, 6).astype(np.float32),
                rng.randint(0, 6, n).astype(np.int64),
                rng.rand(n).astype(np.float32))
    if kind == "bin":
        return (rng.randn(n).astype(np.float32),
                rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32))
    if kind == "reg":
        return (rng.randn(n, 4).astype(np.float32),
                rng.randn(n, 4).astype(np.float32),
                rng.rand(n, 4).astype(np.float32))
    a = boxes()
    return a, a + rng.uniform(-2, 2, a.shape).astype(np.float32) * \
        np.float32([1, 1, 1, 1, 0.05]), rng.rand(n).astype(np.float32)


LOSSES = [
    ("FocalLoss", common, jcommon, dict(), "cls"),
    ("SmoothL1Loss", common, jcommon, dict(beta=0.5), "reg"),
    ("L1Loss", common, jcommon, dict(), "reg"),
    ("CrossEntropyLoss", common, jcommon, dict(), "cls"),
    ("CrossEntropyLoss", common, jcommon, dict(use_sigmoid=True), "bin"),
    ("CrossEntropyLossForRcnn", common, jcommon, dict(), "cls"),
    ("BinaryCrossEntropyLoss", common, jcommon, dict(), "bin"),
    ("PolyIoULoss", poly_iou_loss, jpoly, dict(), "box"),
    ("PolyGIoULoss", poly_iou_loss, jpoly, dict(), "box"),
    ("GDLoss", poly_iou_loss, jpoly, dict(loss_type="gwd"), "box"),
    ("GDLoss", poly_iou_loss, jpoly, dict(loss_type="kld"), "box"),
    ("GDLoss", poly_iou_loss, jpoly, dict(loss_type="kfiou"), "box"),
]


@pytest.mark.parametrize("reduction,avg", [("none", None), ("sum", None),
                                           ("mean", None), ("mean", 7.0)])
@pytest.mark.parametrize("name,mod,jmod,kw,kind", LOSSES,
                         ids=[f"{n}{i}" for i, (n, *_) in enumerate(LOSSES)])
def test_loss_reductions_match_jax(name, mod, jmod, kw, kind, reduction,
                                   avg):
    rng = np.random.RandomState(len(name) + len(kw))
    pred, target, weight = _loss_inputs(kind, rng)
    kw = dict(kw, reduction=reduction, loss_weight=1.5)
    extra = {}
    if kw.get("loss_type") == "kfiou":
        extra = dict(pred_decode=pred, targets_decode=target)
    got = getattr(mod, name)(**kw)(
        torch.from_numpy(pred), torch.from_numpy(target),
        weight=torch.from_numpy(weight), avg_factor=avg,
        **{k: torch.from_numpy(v) for k, v in extra.items()})
    if kind == "cls" and name == "FocalLoss":
        jtarget = jnp.asarray(target)
    else:
        jtarget = jnp.asarray(target.astype(np.int32) if kind == "cls"
                              else target)
    want = np.asarray(getattr(jmod, name)(**kw)(
        jnp.asarray(pred), jtarget, weight=jnp.asarray(weight),
        avg_factor=avg, **{k: jnp.asarray(v) for k, v in extra.items()}))
    got = got.detach().numpy()
    assert got.shape == want.shape
    # the Gaussian losses subtract nearly equal f32 traces (GWD's
    # 2 sqrt(...) term): 1e-4 there
    rtol = 1e-4 if name == "GDLoss" else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
