"""The PyTorch port's modules against their JAX twins, each with the
same weights (JAX ``init``, perturbed, carried across by
``load_jax_variables``) on the same seeded inputs, CPU, f32: VAN, FPN,
the Oriented RPN (forward and proposals), the RoI extractor and the
Oriented head's ``predict``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.models.backbones.van import VAN as JVAN
from rs_detection_tpu.models.necks.fpn import FPN as JFPN
from rs_detection_tpu.models.roi_extractors.oriented_single_level import \
    OrientedSingleRoIExtractor as JExtractor
from rs_detection_tpu.models.roi_heads.oriented_head import \
    OrientedHead as JHead
from rs_detection_tpu.models.roi_heads.oriented_rpn_head import \
    OrientedRPNHead as JRPN
from rs_detection_tpu_torch.models.backbones.van import VAN
from rs_detection_tpu_torch.models.necks.fpn import FPN
from rs_detection_tpu_torch.models.roi_extractors.oriented_single_level \
    import OrientedSingleRoIExtractor
from rs_detection_tpu_torch.models.roi_heads.oriented_head import \
    OrientedHead
from rs_detection_tpu_torch.models.roi_heads.oriented_rpn_head import \
    OrientedRPNHead
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables

ANCHORS = dict(scales=[8], ratios=[0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0],
               strides=[4, 8, 16, 32, 64])
# both sides f32 on the CPU: conv/matmul summation order differs, so
# module outputs agree to ~1e-6 relative; 1e-4 leaves room for depth
RTOL, ATOL = 1e-4, 1e-4


def _perturbed(variables, seed):
    """Non-trivial biases, norm parameters, BN statistics and layer
    scales, so a mis-mapped tensor cannot hide behind its init value."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.array(v, np.float32)
            if k in ("bias", "mean"):
                a = a + 0.1 * rng.randn(*a.shape)
            elif k in ("scale", "var"):
                a = a * (1.0 + 0.5 * rng.rand(*a.shape))
            elif k.startswith("layer_scale"):
                a = rng.uniform(0.2, 0.6, a.shape)
            out[k] = a.astype(np.float32)
        return out

    return {c: walk(jax.tree_util.tree_map(np.asarray, dict(t)))
            for c, t in variables.items()}


def _init(module, seed, *args, **kw):
    v = jax.jit(lambda *a: module.init(jax.random.PRNGKey(seed), *a, **kw))(
        *args)
    return _perturbed(v, seed)


def _nhwc(rng, shapes):
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _t(arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def test_van_matches():
    dims = (16, 32, 40, 64)
    jm = JVAN(embed_dims=dims, mlp_ratios=(8, 8, 4, 4), depths=(1, 1, 2, 1))
    x = np.random.RandomState(0).randn(2, 64, 64, 3).astype(np.float32)
    v = _init(jm, 0, jnp.asarray(x))
    port = load_jax_variables(
        VAN(embed_dims=dims, mlp_ratios=(8, 8, 4, 4), depths=(1, 1, 2, 1))
        .eval(), v)
    ref = jax.jit(jm.apply)(v, jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert len(got) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


def test_fpn_matches():
    dims = (16, 32, 40, 64)
    rng = np.random.RandomState(1)
    feats = _nhwc(rng, [(2, 16, 16, 16), (2, 8, 8, 32), (2, 4, 4, 40),
                        (2, 2, 2, 64)])
    jm = JFPN(in_channels=dims, out_channels=24, num_outs=5)
    v = _init(jm, 1, _j(feats))
    port = load_jax_variables(FPN(dims, 24, num_outs=5).eval(), v)
    ref = jax.jit(jm.apply)(v, _j(feats))
    got = port(_t(feats))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nms_pre,nms_post,cap", [(64, 48, 160), (8, 48, 160)],
                         ids=["capped", "padded"])
def test_rpn_matches(nms_pre, nms_post, cap):
    """Forward, then ``get_proposals`` fed the JAX forward's own outputs
    on both sides, so only the top-k, decode and NMS math differ."""
    rng = np.random.RandomState(2)
    feats = _nhwc(rng, [(2, 16, 16, 24), (2, 8, 8, 24), (2, 4, 4, 24),
                        (2, 2, 2, 24), (2, 1, 1, 24)])
    kw = dict(in_channels=24, feat_channels=24, anchor_generator=ANCHORS,
              nms_pre=nms_pre, nms_post=nms_post, pre_nms_cap=cap)
    jm = JRPN(**kw)
    v = _init(jm, 2, _j(feats))
    # spread the predictions: init's N(0, 0.01) convs give scores that
    # all sit at sigmoid(0) and deltas near 0
    for name in ("rpn_cls", "rpn_reg"):
        v["params"][name]["kernel"] *= 40.0
    port = load_jax_variables(OrientedRPNHead(**kw).eval(), v)
    cls_j, reg_j = jax.jit(jm.apply)(v, _j(feats))
    cls_t, reg_t = port(_t(feats))
    for g, r in zip(cls_t + reg_t, cls_j + reg_j):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)

    img_hw = jnp.full((2, 2), 64.0)
    ref = jax.jit(lambda *a: jm.apply(*a, method=jm.get_proposals))(
        v, cls_j, reg_j, img_hw)
    got = port.get_proposals(_t(cls_j), _t(reg_j))
    props, scores, valid = (np.asarray(a) for a in ref)
    assert props.shape == (2, nms_post, 5)
    np.testing.assert_array_equal(got[2].numpy(), valid)
    assert 0 < valid.sum() < valid.size or nms_post <= cap
    # same scores, and per score the same box; scores that tie would
    # make the order within the tie arbitrary, and there are none here
    np.testing.assert_allclose(got[1].numpy(), scores, rtol=1e-6, atol=1e-7)
    s = scores[valid]
    assert np.unique(s).size == s.size
    np.testing.assert_allclose(got[0].numpy()[valid], props[valid],
                               rtol=1e-5, atol=1e-3)


def _rois(rng, b, p, img=64.0):
    scale = np.exp(rng.uniform(np.log(6), np.log(300), (b, p)))
    aspect = np.exp(rng.uniform(-1.2, 1.2, (b, p)))
    return np.stack([rng.uniform(-0.1, 1.1, (b, p)) * img,
                     rng.uniform(-0.1, 1.1, (b, p)) * img, scale * aspect,
                     scale / aspect, rng.uniform(-np.pi, np.pi, (b, p))],
                    -1).astype(np.float32)


def test_extractor_matches():
    rng = np.random.RandomState(3)
    feats = _nhwc(rng, [(2, 16, 16, 8), (2, 8, 8, 8), (2, 4, 4, 8),
                        (2, 2, 2, 8), (2, 1, 1, 8)])
    props = _rois(rng, 2, 40)
    rois = np.concatenate([np.repeat(np.arange(2.0), 40)[:, None],
                           props.reshape(80, 5)], 1).astype(np.float32)
    ref = JExtractor(extend_factor=(1.4, 1.2))(_j(feats), jnp.asarray(rois))
    got = OrientedSingleRoIExtractor(extend_factor=(1.4, 1.2))(
        _t(feats), torch.from_numpy(rois))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=2e-5)


def test_head_predict_matches():
    rng = np.random.RandomState(4)
    feats = _nhwc(rng, [(2, 16, 16, 8), (2, 8, 8, 8), (2, 4, 4, 8),
                        (2, 2, 2, 8), (2, 1, 1, 8)])
    props = _rois(rng, 2, 30)
    valid = rng.rand(2, 30) > 0.2
    scale = np.asarray([1.0, 0.5], np.float32)
    # the JAX head's default extractor is the port's fixed one
    cfg = dict(num_classes=10, in_channels=8, fc_out_channels=32)
    jm = JHead(**cfg)
    args = (_j(feats), jnp.asarray(props), jnp.asarray(valid),
            jnp.asarray(scale))
    v = _init(jm, 4, *args, method=jm.predict)
    v["params"]["fc_reg"]["kernel"] *= 300.0   # deltas of a real size
    port = load_jax_variables(OrientedHead(**cfg).eval(), v)
    ref = jax.jit(lambda *a: jm.apply(*a, method=jm.predict))(v, *args)
    got = port.predict(_t(feats), torch.from_numpy(props),
                       torch.from_numpy(valid), torch.from_numpy(scale))
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    np.testing.assert_allclose(got["scores"].detach().numpy(),
                               np.asarray(ref["scores"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["polys"].detach().numpy(),
                               np.asarray(ref["polys"]), rtol=1e-5,
                               atol=1e-3)
