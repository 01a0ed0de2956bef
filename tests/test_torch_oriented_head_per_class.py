"""``OrientedHead(reg_class_agnostic=False)`` of the port against the JAX
head on the CPU, f32: ``fc_reg`` 5 C wide, carried by
``utils/jax_weights.py``; the loss (each slot's 5 columns at its clipped
label), its gradients and ``predict`` (which keeps the first class's
decoded box for every roi, as the JAX head does).

The sampler takes every candidate (as many slots as the 30 proposals and
4 ground truths, positives at any fraction), so both sides train on the
same slots whatever their generators draw."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rs_detection_tpu.models.roi_heads.oriented_head import \
    OrientedHead as JHead
from rs_detection_tpu_torch.models.roi_heads.oriented_head import \
    OrientedHead
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_variables)
from test_torch_port_modules import _init, _nhwc, _t
from torch_one_thread import _one_thread  # noqa: F401

CFG = dict(num_classes=3, in_channels=8, fc_out_channels=32,
           reg_class_agnostic=False,
           sampler=dict(num=34, pos_fraction=1.0, add_gt_as_proposals=True))
SHAPES = [(2, 16, 16, 8), (2, 8, 8, 8), (2, 4, 4, 8), (2, 2, 2, 8),
          (2, 1, 1, 8)]


def _inputs():
    rng = np.random.RandomState(4)
    feats = _nhwc(rng, SHAPES)
    scale = np.exp(rng.uniform(np.log(6), np.log(30), (2, 30)))
    aspect = np.exp(rng.uniform(-1.2, 1.2, (2, 30)))
    props = np.stack([rng.uniform(6, 58, (2, 30)),
                      rng.uniform(6, 58, (2, 30)), scale * aspect,
                      scale / aspect,
                      rng.uniform(-np.pi, np.pi, (2, 30))], -1).astype(
        np.float32)
    valid = rng.rand(2, 30) > 0.2
    # ground truths near the first four proposals of each image, so that
    # every class has positives
    rboxes = props[:, :4] + np.float32([0.5, -0.5, 1.0, 0.5, 0.05])
    rboxes[..., 4] *= -1.0            # the data convention's angle sign
    targets = dict(rboxes=rboxes,
                   labels=np.array([[1, 2, 3, 1], [2, 3, 1, 2]], np.int32),
                   gt_mask=np.array([[1, 1, 1, 1], [1, 1, 1, 0]], bool))
    return feats, props, valid, targets


def _pair():
    feats, props, valid, targets = _inputs()
    jm = JHead(**CFG)
    scale = np.asarray([1.0, 0.5], np.float32)
    args = ([jnp.asarray(f) for f in feats], jnp.asarray(props),
            jnp.asarray(valid), jnp.asarray(scale))
    v = _init(jm, 4, *args, method=jm.predict)
    v["params"]["fc_reg"]["kernel"] *= 300.0   # deltas of a real size
    assert v["params"]["fc_reg"]["kernel"].shape == (32, 15)
    port = load_jax_variables(OrientedHead(**CFG), v)
    assert tuple(port.fc_reg.weight.shape) == (15, 32)
    return jm, v, port, args


def test_per_class_predict_matches_jax():
    """Scores to 1e-5, polys to 1e-3 px: the first class's box of every
    roi, rescaled, as the JAX head gives."""
    jm, v, port, args = _pair()
    ref = jax.jit(lambda *a: jm.apply(*a, method=jm.predict))(v, *args)
    got = port.eval().predict(_t(args[0]), *_t(args[1:]))
    assert got["polys"].shape == (2, 30, 8)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(ref["valid"]))
    np.testing.assert_allclose(got["scores"].detach().numpy(),
                               np.asarray(ref["scores"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["polys"].detach().numpy(),
                               np.asarray(ref["polys"]), rtol=1e-5,
                               atol=1e-3)


def test_per_class_loss_and_gradients_match_jax():
    """Both losses to 1e-5 relative, each above 0; the parameters'
    gradients to 1e-5 of each leaf's largest (the loss reads only the
    labelled class's columns of ``fc_reg``: the other columns' gradients
    are 0 on both sides)."""
    jm, v, port, args = _pair()
    feats, props, valid, _ = args
    _, _, _, targets = _inputs()
    jt = {k: jnp.asarray(x) for k, x in targets.items()}
    key = jax.random.PRNGKey(1)

    def jloss(params):
        out = jm.apply({"params": params}, feats, props, valid, jt, key,
                       method=jm.loss)
        return out["loss_cls"] + out["orcnn_bbox_loss"], out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"])
    got = port.train().loss(
        _t(feats), torch.from_numpy(np.array(props)),
        torch.from_numpy(np.array(valid)),
        {k: torch.from_numpy(x) for k, x in targets.items()}, None)
    for k in ("loss_cls", "orcnn_bbox_loss"):
        assert got[k].item() > 0
        assert abs(got[k].item() - float(ref[k])) <= 1e-5 * float(ref[k]), (
            k, got[k].item(), float(ref[k]))
    (got["loss_cls"] + got["orcnn_bbox_loss"]).backward()
    want = jax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    grads = {k: p.grad.numpy() for k, p in port.named_parameters()}
    assert set(grads) == set(want)
    for k, g in want.items():
        scale = max(np.abs(g).max(), 1e-12)
        assert np.abs(grads[k] - g).max() <= 1e-5 * scale, k
    reg = grads["fc_reg.weight"].reshape(3, 5, 32)
    assert all(np.abs(reg[c]).max() > 0 for c in range(3))


def test_per_class_config_builds_through_the_registry():
    """The flagship config with ``reg_class_agnostic=False`` builds (the
    port refused it until this head had the mode): ``fc_reg`` 5 C wide,
    and ``predict`` gives one box per proposal."""
    from rs_detection_tpu_torch.flagship import flagship_cfg
    from rs_detection_tpu_torch.runner import runner as _runner  # noqa: F401
    from rs_detection_tpu_torch.utils.registry import MODELS, build_from_cfg

    cfg = flagship_cfg(tiny=True)
    cfg["bbox_head"]["reg_class_agnostic"] = False
    model = build_from_cfg(cfg, MODELS).eval()
    c = cfg["bbox_head"]["num_classes"]
    assert model.bbox_head.fc_reg.out_features == 5 * c
    with torch.no_grad():
        out = model.predict(torch.zeros(1, 64, 64, 3))
    assert out["polys"].shape[-1] == 8
    assert out["scores"].shape[-1] == c
