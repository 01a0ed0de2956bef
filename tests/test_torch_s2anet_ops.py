"""The ops of the S2ANet slice against their JAX twins on the CPU, f32,
from the same numpy-seeded inputs: the zero-padded bilinear gather, the
deformable convolution (v1 and v2, forward and the gradients of the
input, the weight and the mask; taps pushed outside the image, stride 2,
dilation 2, two deformable groups), the ORN tables and ops, rotated NMS
(with equal scores, class-aware and not) and the fixed-size multiclass
NMS, whose outputs are equal to JAX's. Also the blocked
``box_iou_rotated``: bit for bit what one block gives, across block
edges, batched and not, in both modes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.ops import deform_conv as jdc
from rs_detection_tpu.ops import nms_rotated as jnms
from rs_detection_tpu.ops import orn as jorn
from rs_detection_tpu.ops import sampling as jsampling
from rs_detection_tpu.ops.rotated_iou import box_iou_rotated as jiou
from rs_detection_tpu_torch.ops import nms_rotated as tnms
from rs_detection_tpu_torch.ops import orn
from rs_detection_tpu_torch.ops.deform_conv import deform_conv2d
from rs_detection_tpu_torch.ops.rotated_iou import box_iou_rotated
from rs_detection_tpu_torch.ops.sampling import bilinear_sample_zeros


def _obbs(rng, n, img=200.0, lo=2.0, hi=120.0):
    return np.stack([rng.uniform(0, img, n), rng.uniform(0, img, n),
                     rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                     rng.uniform(-np.pi, np.pi, n)], 1).astype(np.float32)


# ------------------------------------------------------- bilinear, DCN

def test_bilinear_sample_zeros_matches_jax():
    """Points inside, on the border band and far outside (zero there)."""
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 7, 9, 5).astype(np.float32)
    y = rng.uniform(-3, 10, (2, 4, 6)).astype(np.float32)
    x = rng.uniform(-3, 12, (2, 4, 6)).astype(np.float32)
    y[0, 0, :3] = [-1.0, 6.0, 6.5]
    x[0, 0, :3] = [0.0, 8.0, 8.25]
    got = bilinear_sample_zeros(torch.from_numpy(feat), torch.from_numpy(y),
                                torch.from_numpy(x)).numpy()
    ref = np.stack([np.asarray(jsampling.bilinear_sample_zeros(
        jnp.asarray(feat[i]), jnp.asarray(y[i]), jnp.asarray(x[i])))
        for i in range(2)])
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert np.abs(got[:, 0, 0]).max() > 0 and (np.abs(ref) > 0).any()


DCN_CASES = {
    "v1": dict(),
    "borders": dict(spread=6.0),
    "stride2": dict(stride=2),
    "dilation2": dict(dilation=2, padding=2),
    "groups2_v2": dict(deform_groups=2, mask=True),
    "v2": dict(mask=True, spread=3.0),
}


def _dcn_inputs(case, seed=0):
    kw = dict(DCN_CASES[case])
    spread = kw.pop("spread", 1.5)
    with_mask = kw.pop("mask", False)
    k, stride = 3, kw.get("stride", 1)
    pad, dil = kw.get("padding", 1), kw.get("dilation", 1)
    dg = kw.get("deform_groups", 1)
    rng = np.random.RandomState(seed)
    n, h, w, c, cout = 2, 9, 11, 6, 5
    ho = (h + 2 * pad - dil * (k - 1) - 1) // stride + 1
    wo = (w + 2 * pad - dil * (k - 1) - 1) // stride + 1
    x = rng.randn(n, h, w, c).astype(np.float32)
    off = (spread * rng.randn(n, ho, wo, 2 * dg * k * k)).astype(np.float32)
    wt = (0.3 * rng.randn(k, k, c, cout)).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    mask = (rng.rand(n, ho, wo, dg * k * k).astype(np.float32)
            if with_mask else None)
    kw.update(kernel_size=k)
    return x, off, wt, bias, mask, kw, (n, ho, wo, cout)


@pytest.mark.parametrize("case", sorted(DCN_CASES))
def test_deform_conv2d_forward_and_grads_match_jax(case):
    """The output, and the gradients of sum(out * r) for x, the weight
    (the JAX HWIO gradient in the port's OIHW layout) and the mask;
    1e-4 relative to each tensor's largest entry."""
    x, off, wt, bias, mask, kw, oshape = _dcn_inputs(case)
    r = np.random.RandomState(9).randn(*oshape).astype(np.float32)

    def jloss(x, wt, mask):
        out = jdc.deform_conv2d(x, jnp.asarray(off), wt, jnp.asarray(bias),
                                mask, **kw)
        return (out * r).sum(), out

    argnums = (0, 1, 2) if mask is not None else (0, 1)
    (_, ref), jg = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(
        jnp.asarray(x), jnp.asarray(wt),
        None if mask is None else jnp.asarray(mask))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(wt.transpose(3, 2, 0, 1).copy(), requires_grad=True)
    tm = None if mask is None else torch.tensor(mask, requires_grad=True)
    out = deform_conv2d(tx, torch.from_numpy(off), tw, torch.from_numpy(bias),
                        tm, **kw)
    (out * torch.from_numpy(r)).sum().backward()

    def close(got, want):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want,
                                   atol=1e-4 * np.abs(want).max())

    assert out.shape == oshape
    close(out.detach().numpy(), ref)
    close(tx.grad.numpy(), jg[0])
    close(tw.grad.numpy(), np.asarray(jg[1]).transpose(3, 2, 0, 1))
    if mask is not None:
        close(tm.grad.numpy(), jg[2])
    if case == "borders":
        # some taps sample wholly outside: their columns are zero
        assert np.abs(off).max() > 15


# ------------------------------------------------------------------ ORN

@pytest.mark.parametrize("n_or,n_rot,k", [(1, 8, 3), (8, 8, 3), (4, 4, 3),
                                          (1, 8, 1), (2, 8, 1)])
def test_arf_tables_equal_jax(n_or, n_rot, k):
    np.testing.assert_array_equal(orn.arf_indices(n_or, n_rot, k),
                                  jorn.arf_indices(n_or, n_rot, k))
    np.testing.assert_array_equal(orn.arf_gather_indices(n_or, n_rot, k),
                                  jorn.arf_gather_indices(n_or, n_rot, k))


@pytest.mark.parametrize("n_or", [1, 8])
def test_active_rotating_filter_matches_jax(n_or):
    """Non-symmetric weights: every rotated copy is a permutation of its
    filter, laid out o-major, bit for bit."""
    rng = np.random.RandomState(n_or)
    wt = rng.randn(3, 4, n_or * 9).astype(np.float32)
    gi = orn.arf_gather_indices(n_or, 8, 3)
    got = orn.active_rotating_filter(torch.from_numpy(wt), gi).numpy()
    ref = np.asarray(jorn.active_rotating_filter(jnp.asarray(wt), gi))
    assert got.shape == (24, 4, n_or * 9)
    np.testing.assert_array_equal(got, ref)
    # rotation 2 of filter 1 is its 90-degree turn (1-based table)
    turned = wt[1, :, :9].reshape(4, 3, 3)
    if n_or == 1:
        np.testing.assert_array_equal(got[1 * 8 + 2].reshape(4, 3, 3),
                                      np.rot90(turned, -1, axes=(1, 2)))


def test_rotation_invariant_pooling_and_encoding_match_jax():
    """RIP on channels-last [N, H, W, 32] groups channel g * 8 + o into
    group g; RIE with ties (the first orientation wins)."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 4, 32).astype(np.float32)
    got = orn.rotation_invariant_pooling(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jorn.rotation_invariant_pooling(jnp.asarray(x), 8)))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(
        nchw.reshape(2, 4, 8, 3, 4).amax(2).permute(0, 2, 3, 1).numpy(), got)
    f = rng.randn(5, 32).astype(np.float32)
    f[0, 8:16] = 1.0                              # a tied group
    aligned, main = orn.rotation_invariant_encoding(torch.from_numpy(f), 8)
    ja, jm = jorn.rotation_invariant_encoding(jnp.asarray(f), 8)
    np.testing.assert_array_equal(aligned.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(main.numpy(), np.asarray(jm))
    assert main[0, 1] == 0


# ------------------------------------------------------------------ NMS

def _nms_case(seed, n=120):
    """Clustered boxes (so that NMS suppresses), a third of the scores in
    tied groups, 4 labels; no IoU within 1e-5 of the thresholds used (the
    port and JAX IoUs differ by at most 1.4e-6 on these sets, measured)."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(20, 180, (12, 2))
    pick = rng.randint(0, 12, n)
    boxes = _obbs(rng, n, lo=10, hi=50)
    boxes[:, :2] = centres[pick] + rng.randn(n, 2) * 6
    scores = rng.rand(n).astype(np.float32)
    scores[::3] = scores[1::3][:len(scores[::3])]   # equal scores
    labels = rng.randint(0, 4, n)
    iou = np.asarray(jiou(jnp.asarray(boxes), jnp.asarray(boxes)))
    for thr in (0.1, 0.3):
        assert np.abs(iou - thr).min() > 1e-5
    return boxes, scores, labels


@pytest.mark.parametrize("labelled", [False, True], ids=["plain", "labels"])
@pytest.mark.parametrize("thr", [0.1, 0.3])
def test_nms_rotated_mask_equals_jax(labelled, thr):
    boxes, scores, labels = _nms_case(4)
    valid = np.ones(len(boxes), bool)
    valid[5::17] = False
    lab = labels if labelled else None
    got = tnms.nms_rotated_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), thr,
        valid=torch.from_numpy(valid),
        labels=None if lab is None else torch.from_numpy(lab))
    ref = jnms.nms_rotated_mask(
        jnp.asarray(boxes), jnp.asarray(scores), thr,
        valid=jnp.asarray(valid), labels=None if lab is None
        else jnp.asarray(lab))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 10 < got.sum() < valid.sum()


def test_eager_nms_rotated_equals_jax():
    """Distinct scores: both return the kept indices by score."""
    boxes, _, labels = _nms_case(5)
    scores = np.random.RandomState(6).permutation(len(boxes)).astype(
        np.float32) / len(boxes)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    np.testing.assert_array_equal(
        tnms.nms_rotated(tb, ts, 0.1).numpy(),
        jnms.nms_rotated(boxes, scores, 0.1))
    np.testing.assert_array_equal(
        tnms.ml_nms_rotated(tb, ts, torch.from_numpy(labels), 0.1).numpy(),
        jnms.ml_nms_rotated(boxes, scores, labels, 0.1))
    assert tnms.nms_rotated(tb[:0], ts[:0], 0.1).shape == (0,)


@pytest.mark.parametrize("pre_nms,max_num,per_class",
                         [(200, 64, False), (500, 600, False),
                          (300, 100, True)])
def test_multiclass_nms_rotated_jit_equals_jax(pre_nms, max_num, per_class):
    """dets, labels and valid equal to JAX's: the candidates' top-k, the
    class-aware NMS and the output top-k pick the same entries (ties to
    the lower index); padding past the candidates when ``max_num`` is
    larger."""
    boxes, scores, _ = _nms_case(7)
    n = len(boxes)
    rng = np.random.RandomState(8)
    multi = np.concatenate([np.zeros((n, 1), np.float32),
                            rng.rand(n, 4).astype(np.float32)], 1)
    multi[::4, 2] = multi[1::4, 2][:len(multi[::4])]
    if per_class:
        bb = np.concatenate([boxes + rng.randn(n, 5).astype(np.float32)
                             * [[2, 2, 1, 1, 0.05]] for _ in range(5)], 1)
    else:
        bb = boxes
    got = tnms.multiclass_nms_rotated_jit(
        torch.from_numpy(bb.astype(np.float32)), torch.from_numpy(multi),
        0.3, 0.1, pre_nms=pre_nms, max_num=max_num)
    ref = jnms.multiclass_nms_rotated_jit(
        jnp.asarray(bb.astype(np.float32)), jnp.asarray(multi), 0.3, 0.1,
        pre_nms=pre_nms, max_num=max_num)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[0].shape == (max_num, 6) and 20 < got[2].sum() < pre_nms
    dets, labels = tnms.multiclass_nms_rotated(
        torch.from_numpy(bb.astype(np.float32)), torch.from_numpy(multi),
        0.3, dict(iou_thr=0.1), max_num=max_num)
    jd, jl = jnms.multiclass_nms_rotated(bb.astype(np.float32), multi, 0.3,
                                         dict(iou_thr=0.1), max_num=max_num)
    np.testing.assert_array_equal(dets.numpy(), jd)
    np.testing.assert_array_equal(labels.numpy(), jl)


# --------------------------------------------------- blocked rotated IoU

@pytest.mark.parametrize("mode", ["iou", "iof"])
@pytest.mark.parametrize("block", [1, 97, 1000, 4099])
def test_box_iou_rotated_blocks_are_bit_equal(mode, block):
    """123 x 97 boxes (axis-aligned, integer and identical ones among
    them) in blocks of ``block`` pairs (a block holds whole rows: 1 row,
    1 row, 10 rows, 42 rows), and a batch of 3 x [41, 13], against one
    block: ``torch.equal``; and against JAX within 1e-5."""
    rng = np.random.RandomState(11)
    a = torch.from_numpy(_obbs(rng, 123))
    b = torch.from_numpy(_obbs(rng, 97))
    a[::7] = torch.round(a[::7])
    a[5:40:3, 4] = 0.0
    b[:10] = a[:10]
    whole = box_iou_rotated(a, b, mode=mode, pair_block=10 ** 12)
    got = box_iou_rotated(a, b, mode=mode, pair_block=block)
    assert torch.equal(got, whole)
    ba, bb = a.reshape(3, 41, 5), torch.from_numpy(
        _obbs(rng, 39)).reshape(3, 13, 5)
    assert torch.equal(box_iou_rotated(ba, bb, mode=mode, pair_block=block),
                       box_iou_rotated(ba, bb, mode=mode,
                                       pair_block=10 ** 12))
    ref = np.asarray(jiou(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()),
                          mode=mode))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    assert (whole > 0.05).sum() > 40


def test_box_iou_rotated_default_block_and_self_iou():
    """The default budget holds 2^21 pairs; NMS's self-IoU (every
    candidate point doubled on the diagonal) is blocking-independent
    too, and exactly 1 on the diagonal of identical boxes up to f32."""
    from rs_detection_tpu_torch.ops.rotated_iou import PAIR_BLOCK

    assert PAIR_BLOCK == 2 ** 21
    b = torch.from_numpy(_obbs(np.random.RandomState(12), 300))
    whole = box_iou_rotated(b, b)
    assert torch.equal(whole, box_iou_rotated(b, b, pair_block=777))
    assert (whole.diagonal() - 1.0).abs().max() < 1e-5


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_box_iou_rotated_pseudo_angle_near_ties(mode, monkeypatch):
    """The candidates' sort key at near ties: 200 boxes against copies
    moved by up to 1e-3 px and 1e-6 rad, exact copies, and copies turned
    a quarter with w and h swapped (the same box), so many candidate
    points nearly coincide. The pseudo-angle against an ``atan2`` key
    moves no IoU by more than 1e-6 (4.8e-7 measured, in 2 of 40,000
    pairs), and both stay within 2e-5 of JAX (1.03e-5 measured)."""
    from rs_detection_tpu_torch.ops import rotated_iou

    rng = np.random.RandomState(13)
    a = _obbs(rng, 200)
    b = a.copy()
    b[:, :4] += rng.uniform(-1e-3, 1e-3, (200, 4)).astype(np.float32)
    b[:, 4] += rng.uniform(-1e-6, 1e-6, 200).astype(np.float32)
    b[::4] = a[::4]
    b[1::4, 4] = a[1::4, 4] + np.float32(np.pi / 2)
    b[1::4, 2:4] = a[1::4, 3:1:-1]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got = box_iou_rotated(ta, tb, mode=mode)
    monkeypatch.setattr(rotated_iou, "_pseudo_angle",
                        lambda vx, vy: torch.atan2(vy, vx))
    by_atan2 = box_iou_rotated(ta, tb, mode=mode)
    ref = np.asarray(jiou(jnp.asarray(a), jnp.asarray(b), mode=mode))
    assert (got - by_atan2).abs().max() <= 1e-6
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    np.testing.assert_allclose(by_atan2.numpy(), ref, atol=2e-5)
    assert got.diagonal().min() > 0.999
