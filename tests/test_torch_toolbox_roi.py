"""The port's single-level RoI operators against the JAX package on the
CPU: ``roi_align_rotated`` (and ``ROIAlignRotated`` / ``_v1``),
``roi_pool``, ``psroi_align`` (and ``PSROIAlign``), DCN v2's
``deform_roi_pooling`` and ``DCNPooling`` (its weights a flax tree carried
by ``utils/jax_weights.py``), forward and gradients against ``jax.grad``.
Seeded numpy inputs, NHWC features, f32.

Tolerances: 1e-5 absolute on outputs and gradients of O(1) (f32 sums of
at most 64 samples a bin; the rotated sampling's sines and cosines agree
to an ulp). ``roi_pool``'s gradient is the max's: both sides split it
evenly among tied samples, and the rois here have no tie inside the
image."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.ops import dcn_pool as jdcn
from rs_detection_tpu_torch.ops import dcn_pool as dcn
from rs_detection_tpu_torch.ops import roi_align as ra
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from torch_one_thread import _one_thread  # noqa: F401

# the package's ``ops`` exports a function of the module's name
jra = importlib.import_module("rs_detection_tpu.ops.roi_align")
TOL = 1e-5


def _feats(seed, c=8, n=2, h=16, w=20):
    return np.random.RandomState(seed).randn(n, h, w, c).astype(np.float32)


def _rotated_rois(seed, r=24, img=(64, 80)):
    rng = np.random.RandomState(seed)
    rois = np.stack([
        rng.randint(0, 2, r), rng.uniform(-8, img[1] + 8, r),
        rng.uniform(-8, img[0] + 8, r), rng.uniform(2, 40, r),
        rng.uniform(2, 30, r), rng.uniform(-np.pi, np.pi, r)], 1)
    return rois.astype(np.float32)


def _hbb_rois(seed, r=24, img=(64, 80)):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-6, img[1] - 4, r)
    y1 = rng.uniform(-6, img[0] - 4, r)
    return np.stack([rng.randint(0, 2, r), x1, y1,
                     x1 + rng.uniform(1, 40, r),
                     y1 + rng.uniform(1, 30, r)], 1).astype(np.float32)


def _grads(jfn, tfn, arrays, seed):
    """(jax output, port output, jax grads, port grads) of
    sum(out * random weight) over ``arrays``."""
    out = np.asarray(jfn(*[jnp.asarray(a) for a in arrays]))
    wt = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    jg = jax.grad(lambda *a: (jfn(*a) * wt).sum(), argnums=tuple(
        range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = tfn(*ts)
    (got * torch.from_numpy(wt)).sum().backward()
    return out, got.detach().numpy(), [np.asarray(g) for g in jg], [
        t.grad.numpy() for t in ts]


@pytest.mark.parametrize("scale", [0.25, 0.125, 0.3])
def test_roi_align_rotated_matches_jax(scale):
    """Forward and feature gradient at the zoo's scales and one that no
    power of two gives (JAX multiplies by ``spatial_scale`` in f32, as
    the port does); two rois with a batch index outside the batch read
    the rows JAX's gather reads."""
    feats = _feats(1)
    rois = _rotated_rois(2)
    rois[0, 0], rois[1, 0] = 2, -1
    img = (16 / scale, 20 / scale)
    rois[:, 1] *= img[1] / 80
    rois[:, 2] *= img[0] / 64
    out, got, jg, tg = _grads(
        lambda f: jra.roi_align_rotated(f, jnp.asarray(rois), 7, scale, 2),
        lambda f: ra.roi_align_rotated(f, torch.from_numpy(rois), 7, scale,
                                       2), [feats], 3)
    assert np.abs(out).max() > 0.1
    np.testing.assert_allclose(got, out, atol=TOL)
    np.testing.assert_allclose(tg[0], jg[0], atol=TOL)


def test_roi_align_rotated_modules():
    feats = _feats(4)
    rois = _rotated_rois(5)
    ref = np.asarray(jra.ROIAlignRotated_v1((7, 7), 0.25, 0)(
        jnp.asarray(feats), jnp.asarray(rois)))
    assert ra.ROIAlignRotated_v1 is ra.ROIAlignRotated
    for cls in (ra.ROIAlignRotated, ra.ROIAlignRotated_v1):
        got = cls((7, 7), 0.25, 0)(torch.from_numpy(feats),
                                   torch.from_numpy(rois))
        np.testing.assert_allclose(got.numpy(), ref, atol=TOL)


def test_roi_align_rotated_bf16_features_keep_their_dtype():
    feats = torch.from_numpy(_feats(6)).bfloat16()
    rois = torch.from_numpy(_rotated_rois(7))
    got = ra.roi_align_rotated(feats, rois, 7, 0.25)
    ref = ra.roi_align_rotated(feats.float(), rois, 7, 0.25)
    assert got.dtype == torch.bfloat16
    assert (got.float() - ref).abs().max() <= 0.05


@pytest.mark.parametrize("scale", [0.25, 0.5])
def test_roi_pool_matches_jax(scale):
    feats = _feats(8)
    rois = _hbb_rois(9)
    rois[:, 1:] *= 0.25 / scale
    out, got, jg, tg = _grads(
        lambda f: jra.roi_pool(f, jnp.asarray(rois), 7, scale),
        lambda f: ra.roi_pool(f, torch.from_numpy(rois), 7, scale),
        [feats], 10)
    np.testing.assert_allclose(got, out, atol=TOL)
    np.testing.assert_allclose(tg[0], jg[0], atol=TOL)


def test_psroi_align_matches_jax():
    """7^2 * 2 channels: bin (i, j) reads group i * 7 + j."""
    feats = _feats(11, c=98)
    rois = _hbb_rois(12)
    out, got, jg, tg = _grads(
        lambda f: jra.psroi_align(f, jnp.asarray(rois), 7, 0.25, 2),
        lambda f: ra.psroi_align(f, torch.from_numpy(rois), 7, 0.25, 2),
        [feats], 13)
    assert got.shape == (24, 7, 7, 2)
    np.testing.assert_allclose(got, out, atol=TOL)
    np.testing.assert_allclose(tg[0], jg[0], atol=TOL)
    mod = ra.PSROIAlign(7, 0.25, 2)(torch.from_numpy(feats),
                                    torch.from_numpy(rois))
    np.testing.assert_allclose(
        mod.numpy(), np.asarray(jra.PSROIAlign(7, 0.25, 2)(
            jnp.asarray(feats), jnp.asarray(rois))), atol=TOL)


def test_psroi_align_refuses_a_channel_count_p2_does_not_divide():
    feats = _feats(14, c=50)
    rois = _hbb_rois(15, r=3)
    with pytest.raises(TypeError):
        jra.psroi_align(jnp.asarray(feats), jnp.asarray(rois), 7, 0.25, 2)
    with pytest.raises(RuntimeError):
        ra.psroi_align(torch.from_numpy(feats), torch.from_numpy(rois), 7,
                       0.25, 2)


DCN_ROIS = np.array([[0, 4, 4, 16, 12], [1, 2, 6, 20, 20],
                     [0, 10, 10, 13, 13], [1, -6, 30, 52, 60],
                     [0, 30, 2, 47.6, 9.4]], np.float32)


@pytest.mark.parametrize("case", ["no_trans", "offsets", "groups"])
def test_deform_roi_pooling_matches_jax(case):
    """The cases of ``tests/test_dcn_pool.py`` on the same features, with
    rois that leave the image (masked samples, one bin with none in
    range), and the gradients with respect to the features and the
    offsets."""
    feats = np.random.RandomState(0).rand(2, 24, 24, 8).astype(np.float32)
    kw = dict(output_size=7, spatial_scale=0.5, sample_per_part=4)
    offsets = None
    if case == "offsets":
        offsets = np.random.RandomState(1).randn(5, 2, 7, 7).astype(
            np.float32)
        kw["trans_std"] = 0.1
    elif case == "groups":
        kw.update(output_size=4, group_size=2, sample_per_part=2)
    arrays = [feats] + ([offsets] if offsets is not None else [])

    def jfn(f, o=None):
        return jdcn.deform_roi_pooling(f, jnp.asarray(DCN_ROIS), o, **kw)

    def tfn(f, o=None):
        return dcn.deform_roi_pooling(f, torch.from_numpy(DCN_ROIS), o, **kw)

    out, got, jg, tg = _grads(jfn, tfn, arrays, 2)
    assert got.shape == out.shape
    np.testing.assert_allclose(got, out, atol=TOL)
    for j, t in zip(jg, tg):
        assert np.abs(j).max() > 0
        np.testing.assert_allclose(t, j, atol=TOL)


def test_dcn_pooling_from_a_flax_tree_matches_jax():
    """``DCNPooling`` built through ``BRICKS`` from the JAX module's
    fields, its weights the flax tree (fc3 drawn non-zero so that the
    offsets and the mask matter): the output, and the gradients with
    respect to the features and every FC weight."""
    assert reg.BRICKS.get("DCNPooling") is dcn.DCNPooling
    assert {"BRICKS", "SHARED_HEADS"} <= set(vars(reg))
    feats = np.random.RandomState(3).rand(2, 24, 24, 8).astype(np.float32)
    kw = dict(spatial_scale=0.5, pooled_size=7, output_dim=8,
              trans_std=0.1, deform_fc_dim=32)
    jm = jdcn.DCNPooling(**kw)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                               jnp.asarray(DCN_ROIS)))
    rng = np.random.RandomState(4)
    params = jax.tree_util.tree_map(np.array, v["params"])
    params["fc3"]["kernel"] = rng.randn(32, 147).astype(np.float32) * 0.5
    params["fc3"]["bias"] = rng.randn(147).astype(np.float32) * 0.5
    port = reg.build_from_cfg(dict(type="DCNPooling", **kw), reg.BRICKS)
    load_jax_variables(port, {"params": params})

    def jloss(p, f):
        return (jm.apply({"params": p}, f, jnp.asarray(DCN_ROIS)) * wt).sum()

    out = np.asarray(jm.apply({"params": params}, jnp.asarray(feats),
                              jnp.asarray(DCN_ROIS)))
    wt = rng.randn(*out.shape).astype(np.float32)
    gp, gf = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(feats))
    f = torch.tensor(feats, requires_grad=True)
    got = port(f, torch.from_numpy(DCN_ROIS))
    (got * torch.from_numpy(wt)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), out, atol=TOL)
    assert np.abs(out - np.asarray(jdcn.deform_roi_pooling(
        jnp.asarray(feats), jnp.asarray(DCN_ROIS), None, output_size=7,
        spatial_scale=0.5, output_dim=8)) * 0.5).max() > 1e-2
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(gf), atol=TOL)
    for name in ("fc1", "fc2", "fc3"):
        lin = getattr(port, name)
        np.testing.assert_allclose(lin.weight.grad.numpy().T,
                                   np.asarray(gp[name]["kernel"]), atol=TOL)
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   np.asarray(gp[name]["bias"]), atol=TOL)
