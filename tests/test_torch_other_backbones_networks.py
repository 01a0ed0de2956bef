"""The tiny LSKNet Oriented R-CNN (``flagship_cfg(tiny=True)`` on a narrow
LSKNet) and the tiny ConvNeXt RoI-Transformer (``tests/
test_networks_smoke.py:94-125``'s cascade on a narrow ConvNeXt) of the
port against the JAX networks: one config dict built by each framework's
registry, the JAX init (perturbed, layer scales and ``gamma`` off their
init) carried across by ``load_jax_variables``, CPU, f32, ``predict``
and the training losses in one JAX compile per network, first-k sampling
on both sides (``tests/test_torch_roitrans_cuda.py:first_k_sample``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.models.boxes import sampler as jsampler
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import load_jax_variables
from test_torch_fcos_networks import one_thread
from test_torch_other_backbones import perturb_more
from test_torch_other_backbones_cuda import TINY_NETWORKS
from test_torch_roitrans_cuda import first_k_sample
from test_torch_roitrans_modules import _first_k_jax
from test_torch_roitrans_networks import _data

LOSSES = {
    "lsknet_orcnn": {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls",
                     "orcnn_bbox_loss"},
    "convnext_roitrans": {"loss_rpn_cls", "loss_rpn_bbox",
                          "rbbox_cls_loss_1", "rbbox_reg_loss_1",
                          "rbbox_cls_loss_2", "rbbox_reg_loss_2"},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with one_thread():
        yield


_RUNS = {}


def run(kind):
    """(JAX predict, JAX losses, port predict, port losses) of one tiny
    network on ``_data()``, both samplers taking the first candidates."""
    if kind not in _RUNS:
        images, targets = _data()
        cfg = TINY_NETWORKS[kind]()
        jm = jreg.build_from_cfg(cfg, jreg.MODELS)
        jt = {k: jnp.asarray(v) for k, v in targets.items()}
        v = jax.jit(lambda i: jm.init({"params": jax.random.PRNGKey(0)},
                                      i))(jnp.asarray(images))
        v = perturb_more(v, seed=7)
        # spread the RPN's scores, so that its top-k does not tie
        v["params"]["_rpn"]["rpn_cls"]["kernel"] *= 40.0
        port = load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jsampler.RandomSampler, "sample", _first_k_jax)
            mp.setattr(RandomSampler, "sample", first_k_sample)

            def both(v, i):
                pred = jm.apply(v, i, method=jm.predict)
                losses, _ = jm.apply(v, i, jt, method=jm.loss,
                                     mutable=["batch_stats"],
                                     rngs={"sampler": jax.random.PRNGKey(2)})
                return pred, losses

            ref_pred, ref_loss = jax.jit(both)(v, jnp.asarray(images))
            x = torch.from_numpy(images)
            with torch.no_grad():
                got_pred = port.eval().predict(x)
                got_loss = port.train().loss(
                    x, {k: torch.from_numpy(a) for k, a in targets.items()},
                    None)
        _RUNS[kind] = (jax.tree_util.tree_map(np.asarray, ref_pred),
                       {k: float(a) for k, a in ref_loss.items()},
                       got_pred, {k: float(a) for k, a in got_loss.items()})
    return _RUNS[kind]


@pytest.mark.parametrize("kind", sorted(TINY_NETWORKS))
def test_tiny_network_predicts_like_jax(kind):
    """The same valid proposals, polys to 1e-3 px and scores to 5e-5 (as
    ``test_torch_roitrans_networks.py``: f32 through the perturbed
    backbone and one or two FC trunks)."""
    ref, _, got, _ = run(kind)
    valid = ref["valid"]
    assert valid.sum() > 16
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"],
                               atol=5e-5)
    np.testing.assert_allclose(got["polys"].numpy(), ref["polys"], atol=1e-3)
    assert got["scores"].std() > 1e-3


@pytest.mark.parametrize("kind", sorted(TINY_NETWORKS))
def test_tiny_network_loss_like_jax(kind):
    """Every loss within 1e-4 relative (train-mode batch statistics in f32
    on both sides through LSKNet), each finite and above 0."""
    _, ref, _, got = run(kind)
    assert set(got) == set(ref) == LOSSES[kind]
    for k, r in ref.items():
        assert np.isfinite(r) and r > 0, (k, r)
        assert abs(got[k] - r) <= 1e-4 * abs(r), (k, got[k], r)
