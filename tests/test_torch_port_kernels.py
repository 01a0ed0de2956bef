"""The plain PyTorch versions beside the port's two CUDA kernels, held
against the JAX package on the CPU: the VAN MLP (K2) against
``_ref_mlp`` and the Pallas kernel in interpret mode, the rotated
pyramid RoIAlign (K1) against the exact XLA gather path and the Pallas
path in interpret mode. Also the VAN attention body and the rule that
a wrapper never falls back from a non-CPU tensor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.ops.pallas_roi_align import \
    roi_align_rotated_pyramid_pallas
from rs_detection_tpu.ops.pallas_van_attn import _sa_core
from rs_detection_tpu.ops.pallas_van_mlp import _ref_mlp, van_mlp as jvan_mlp
from rs_detection_tpu.ops.roi_align import roi_align_rotated_pyramid as jroi
from rs_detection_tpu_torch.ops.roi_align import (
    roi_align_rotated_pyramid, roi_align_rotated_pyramid_cuda,
    roi_align_rotated_pyramid_reference)
from rs_detection_tpu_torch.ops.van_attn import sa_core
from rs_detection_tpu_torch.ops.van_mlp import (van_mlp, van_mlp_cuda,
                                                van_mlp_reference)
from torch_one_thread import _one_thread  # noqa: F401

STRIDES = (4, 8, 16, 32)


def _mlp_inputs(seed, n=2, h=9, w=11, c=20, ch=40):
    """Odd spatial sizes exercise the hidden tensor's padding mask."""
    rng = np.random.RandomState(seed)
    f = np.float32
    x = rng.randn(n, h, w, c).astype(f)
    w1 = (rng.randn(ch, c) / np.sqrt(c)).astype(f)
    wdw = (rng.randn(ch, 9) / 3).astype(f)
    w2 = (rng.randn(c, ch) / np.sqrt(ch)).astype(f)
    b1, bdw, b2 = (0.3 * rng.randn(k).astype(f) for k in (ch, ch, c))
    return x, w1, b1, wdw, bdw, w2, b2


def _jax_layout(x, w1, b1, wdw, bdw, w2, b2):
    return tuple(jnp.asarray(a) for a in (x, w1.T, b1, wdw.T, bdw, w2.T, b2))


@pytest.mark.parametrize("jax_fn", [_ref_mlp, jvan_mlp],
                         ids=["ref_mlp", "pallas_interpret"])
def test_van_mlp_reference_matches_jax(jax_fn):
    args = _mlp_inputs(0)
    got = van_mlp_reference(*(torch.from_numpy(a) for a in args))
    ref = np.asarray(jax_fn(*_jax_layout(*args)))
    # f32 on both sides: summation order and the JAX GELU's 1.5e-7 erf
    # polynomial; outputs are O(1)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_van_mlp_dispatch_cpu_and_no_fallback():
    args = [torch.from_numpy(a) for a in _mlp_inputs(1)]
    torch.testing.assert_close(van_mlp(*args), van_mlp_reference(*args),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        van_mlp_cuda(*args)          # CPU tensors never reach a kernel
    with pytest.raises(ValueError):
        van_mlp(*(a.to("meta") for a in args))


def test_sa_core_matches_jax():
    rng = np.random.RandomState(2)
    f = np.float32
    c = 12
    h = rng.randn(2, 13, 10, c).astype(f)
    wp1, wc1, wp2 = ((rng.randn(c, c) / np.sqrt(c)).astype(f)
                     for _ in range(3))
    w5 = (rng.randn(25, c) / 5).astype(f)
    w7 = (rng.randn(49, c) / 7).astype(f)
    bp1, b5, b7, bc1, bp2 = (0.2 * rng.randn(c).astype(f) for _ in range(5))
    ref = _sa_core(jnp.asarray(h), jnp.asarray(wp1), jnp.asarray(bp1),
                   jnp.asarray(w5), jnp.asarray(b5), jnp.asarray(w7),
                   jnp.asarray(b7), jnp.asarray(wc1), jnp.asarray(bc1),
                   jnp.asarray(wp2), jnp.asarray(bp2))

    def pw(w):   # [in, out] -> [out, in, 1, 1]
        return torch.from_numpy(np.ascontiguousarray(w.T))[:, :, None, None]

    def dw(w, k):  # [k*k, C] -> [C, 1, k, k]
        return torch.from_numpy(np.ascontiguousarray(w.T)).reshape(c, 1, k, k)

    t = torch.from_numpy
    got = sa_core(t(h), pw(wp1), t(bp1), dw(w5, 5), t(b5), dw(w7, 7), t(b7),
                  pw(wc1), t(bc1), pw(wp2), t(bp2))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=1e-5)


def _pyramid(rng, n=2, c=16, base=64):
    return [rng.randn(n, base // (s // 4), base // (s // 4), c)
            .astype(np.float32) for s in STRIDES]


def _rois(rng, r, n, img=256.0):
    """Every level (sqrt-area 10..600 px), rotations over a full turn,
    and centres up to 25% past each border so samples fall outside."""
    scale = np.exp(rng.uniform(np.log(10), np.log(600), r))
    aspect = np.exp(rng.uniform(-1.5, 1.5, r))
    return np.stack([rng.randint(0, n, r), rng.uniform(-0.25, 1.25, r) * img,
                     rng.uniform(-0.25, 1.25, r) * img, scale * aspect,
                     scale / aspect, rng.uniform(-np.pi, np.pi, r)],
                    1).astype(np.float32)


def test_roi_align_reference_matches_xla_path():
    rng = np.random.RandomState(3)
    feats = _pyramid(rng)
    rois = _rois(rng, 400, 2)
    lvl = np.clip(np.floor(np.log2(np.sqrt(rois[:, 3] * rois[:, 4]) / 56
                                   + 1e-6)), 0, 3)
    assert set(lvl.tolist()) == {0, 1, 2, 3}
    got = roi_align_rotated_pyramid_reference(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois))
    ref = np.asarray(jroi([jnp.asarray(f) for f in feats], jnp.asarray(rois),
                          7, strides=STRIDES))
    assert (np.abs(ref).sum(axis=(1, 2, 3)) == 0).any()  # wholly outside
    # f32 bilinear weights and a 4-sample mean of O(1) features
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=1e-5)


def test_roi_align_reference_matches_pallas_interpret():
    rng = np.random.RandomState(4)
    feats = _pyramid(rng, c=32)
    rois = _rois(rng, 64, 2)
    got = roi_align_rotated_pyramid_reference(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(rois))
    # fallback_frac=1.0: the exact tail covers every oversize roi, so
    # no roi is window-clamped (the tier>=1 count stays within the cap)
    ref = np.asarray(roi_align_rotated_pyramid_pallas(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), 7,
        strides=STRIDES, fallback_frac=1.0, interpret=True))
    # the Pallas forward builds an interpolation matrix in f32 and
    # reduces with a matmul: a different summation order
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=1e-4)


def test_roi_align_dispatch_cpu_and_no_fallback():
    rng = np.random.RandomState(5)
    feats = [torch.from_numpy(f) for f in _pyramid(rng)]
    rois = torch.from_numpy(_rois(rng, 20, 2))
    torch.testing.assert_close(roi_align_rotated_pyramid(feats, rois),
                               roi_align_rotated_pyramid_reference(feats,
                                                                   rois),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        roi_align_rotated_pyramid_cuda(feats, rois)
    with pytest.raises(ValueError):
        roi_align_rotated_pyramid(feats, rois.to("meta"))
