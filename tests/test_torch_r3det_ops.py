"""R3Det's gather in the port against the JAX package, CPU, f32:
``ops/sampling.bilinear_sample`` (the reference's border band) and
``ops/fr.feature_refine`` for 1 and 5 points, forward and gradient with
respect to the features, on points that span the inside, the border band,
the clamped last row and column and the outside."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.ops.fr import feature_refine as jfeature_refine
from rs_detection_tpu.ops.sampling import bilinear_sample as jbilinear
from rs_detection_tpu_torch.ops.sampling import bilinear_sample
from test_torch_fcos_networks import _one_thread  # noqa: F401
from test_torch_r3det_cuda import fr_fwd_bwd, fr_inputs


def test_bilinear_sample_matches_jax_forward_and_gradient():
    """3 x 400 points over [-3, W + 3] x [-3, H + 3] of two 9 x 11 maps
    (with exact integers, -1 and H / W among them): values within 1e-6,
    the gradient of a weighted sum with respect to the features within
    1e-5 of jax.grad's largest entry; points outside the band give 0."""
    rng = np.random.RandomState(0)
    feats = rng.randn(2, 9, 11, 3).astype(np.float32)
    y = rng.uniform(-3, 12, (2, 3, 400)).astype(np.float32)
    x = rng.uniform(-3, 14, (2, 3, 400)).astype(np.float32)
    y[:, 0, :6] = [-1, 0, 8, 9, 3, -1.5]
    x[:, 0, :6] = [-1, 0, 10, 11, 4, 2]
    wgt = rng.rand(2, 3, 400, 3).astype(np.float32)

    def jsum(f):
        out = jax.vmap(jbilinear)(f, jnp.asarray(y), jnp.asarray(x))
        return (out * wgt).sum(), out

    (_, ref), ref_g = jax.value_and_grad(jsum, has_aux=True)(
        jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = bilinear_sample(f, torch.from_numpy(y), torch.from_numpy(x))
    (got * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    ref_g = np.asarray(ref_g)
    np.testing.assert_allclose(f.grad.numpy(), ref_g,
                               atol=1e-5 * np.abs(ref_g).max())
    assert (got[0, 0, 5] == 0).all() and (got[0, 0, 0] != 0).all()


@pytest.mark.parametrize("points", [1, 5])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_feature_refine_matches_jax_forward_and_gradient(points, scale):
    """``tests/test_torch_parity_fr.py``'s inputs in (cx, cy, w, h,
    theta), as both packages take them: the refined features within 1e-5
    and the gradient of a weighted sum with respect to the features
    within 1e-5 of JAX's largest entry (autograd's scatter-add through the
    gather on both sides)."""
    feats, boxes = fr_inputs(seed=points * 7 + int(scale * 2))
    got, got_g = fr_fwd_bwd("cpu", feats, boxes, scale, points)

    def jsum(f):
        out = jfeature_refine(f, jnp.asarray(boxes), scale, points=points)
        wgt = jnp.arange(out.size, dtype=jnp.float32).reshape(out.shape)
        return jnp.sum(out * wgt), out

    (_, ref), ref_g = jax.value_and_grad(jsum, has_aux=True)(
        jnp.asarray(feats))
    ref, ref_g = np.asarray(ref), np.asarray(ref_g)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), ref_g,
                               atol=1e-5 * np.abs(ref_g).max())


def test_feature_refine_rejects_other_point_counts():
    from rs_detection_tpu_torch.ops.fr import feature_refine

    with pytest.raises(ValueError, match="points"):
        feature_refine(torch.zeros(1, 2, 2, 1), torch.zeros(1, 2, 2, 5), 1.0,
                       points=4)
