"""``RoITransformer`` (smooth L1 and KFIoU stage 2) and ``FasterRCNNOBB``
of the port against the JAX networks of
``tests/test_networks_smoke.py:94-125`` (ResNet-18, a 32-wide FPN with
``on_input`` extra convs, the hbb RPN, the cascade head), one config
dict built by each framework's registry, the JAX init (perturbed)
carried across by ``load_jax_variables``, CPU, f32: ``predict`` and the
training losses (first-k sampling on both sides; ResNet's batch
statistics in both). Also a saved JAX RoI-Transformer tree loading
through ``jax_weights``, and ``flagship.make_targets``' hboxes."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.models.boxes import sampler as jsampler
from rs_detection_tpu.ops import box_ops as JB
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.flagship import make_targets, normalize
from rs_detection_tpu_torch.models.boxes.sampler import RandomSampler
from rs_detection_tpu_torch.utils import registry as reg
from rs_detection_tpu_torch.utils.jax_weights import (load_jax_checkpoint,
                                                      load_jax_variables)
from test_torch_port_slice import perturb
from test_torch_roitrans_cuda import TINY_KINDS, first_k_sample, tiny_model
from test_torch_roitrans_modules import _first_k_jax

IMG = 64


def _data():
    """Two 64^2 tiles and 4 ground truths each (one slot padded), with
    their hbbs and polygons as the data pipeline makes them."""
    rng = np.random.RandomState(0)
    tiles = rng.randint(0, 256, (2, IMG, IMG, 3)).astype(np.uint8)
    rboxes = np.zeros((2, 5, 5), np.float32)
    rboxes[:, :4] = [[30, 30, 20, 10, 0.3], [45, 40, 12, 6, -0.4],
                     [16, 20, 24, 16, 0.0], [40, 16, 10, 28, 1.2]]
    rboxes[1, :, :2] += 3.0
    polys = JB.rotated_box_to_poly_np(rboxes.reshape(-1, 5)).reshape(2, 5, 8)
    hboxes = np.stack([polys[..., 0::2].min(-1), polys[..., 1::2].min(-1),
                       polys[..., 0::2].max(-1), polys[..., 1::2].max(-1)],
                      -1)
    mask = np.zeros((2, 5), bool)
    mask[:, :4] = True
    mask[1, 3] = False
    labels = np.tile(np.asarray([1, 2, 3, 4, 0], np.int32), (2, 1))
    targets = dict(rboxes=rboxes, hboxes=hboxes, gt_mask=mask, labels=labels,
                   img_hw=np.full((2, 2), IMG, np.float32))
    return normalize(torch.from_numpy(tiles)).numpy(), targets


_PAIRS = {}


def _pair(kind):
    """The JAX model with perturbed variables (the RPN's cls conv spread
    so that its scores do not tie), and the port's with them."""
    if kind not in _PAIRS:
        images, targets = _data()
        cfg = tiny_model(kind)
        jm = jreg.build_from_cfg(cfg, jreg.MODELS)
        jt = {k: jnp.asarray(v) for k, v in targets.items()}
        v = jax.jit(lambda i, t: jm.init(
            {"params": jax.random.PRNGKey(0),
             "sampler": jax.random.PRNGKey(1)}, i, t))(jnp.asarray(images),
                                                      jt)
        v = perturb(v, seed=7)
        v["params"]["_rpn"]["rpn_cls"]["kernel"] *= 40.0
        port = load_jax_variables(reg.build_from_cfg(cfg, reg.MODELS), v)
        _PAIRS[kind] = jm, v, port
    return _PAIRS[kind]


@pytest.mark.parametrize("kind", sorted(TINY_KINDS))
def test_tiny_network_predicts_like_jax(kind):
    """The same valid proposals, polys to 1e-3 px (as
    ``test_torch_orcnn_configs.py``'s tiny forms) and scores to 5e-5: f32
    through ResNet-18 with perturbed norms and one or two 1568 -> 1024 ->
    1024 FC trunks gives logits near 10 that differ by ~1e-6 relative,
    and softmax scores near 1 that differ by up to 1.3e-5 (measured)."""
    images, _ = _data()
    jm, v, port = _pair(kind)
    ref = jax.jit(lambda v, i: jm.apply(v, i, method=jm.predict))(
        v, jnp.asarray(images))
    got = port.eval().predict(torch.from_numpy(images))
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 16 and got["polys"].shape == (2, 32, 8)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=5e-5)
    np.testing.assert_allclose(got["polys"].numpy(), np.asarray(ref["polys"]),
                               atol=1e-3)


@pytest.mark.parametrize("kind", sorted(TINY_KINDS))
def test_tiny_network_loss_like_jax(kind, monkeypatch):
    """Every loss of ``loss`` within 1e-4 relative (train-mode batch
    statistics in f32 on both sides), each finite and above 0."""
    monkeypatch.setattr(jsampler.RandomSampler, "sample", _first_k_jax)
    monkeypatch.setattr(RandomSampler, "sample", first_k_sample)
    images, targets = _data()
    jm, v, port = _pair(kind)
    jt = {k: jnp.asarray(x) for k, x in targets.items()}
    ref, _ = jax.jit(lambda v, i: jm.apply(
        v, i, jt, method=jm.loss, mutable=["batch_stats"],
        rngs={"sampler": jax.random.PRNGKey(2)}))(v, jnp.asarray(images))
    got = port.train().loss(
        torch.from_numpy(images),
        {k: torch.from_numpy(x) for k, x in targets.items()}, None)
    want = {"loss_rpn_cls", "loss_rpn_bbox", "rbbox_cls_loss_1",
            "rbbox_reg_loss_1"}
    if kind != "faster_rcnn_obb":
        want |= {"rbbox_cls_loss_2", "rbbox_reg_loss_2"}
    assert set(got) == set(ref) == want
    for k in ref:
        r = float(ref[k])
        assert np.isfinite(r) and r > 0, (k, r)
        assert abs(float(got[k]) - r) <= 1e-4 * abs(r), (k, float(got[k]), r)


def test_saved_jax_tree_loads(tmp_path):
    """A JAX RoI-Transformer variables tree pickled as numpy arrays loads
    through ``load_jax_checkpoint`` / ``load_jax_variables`` into every
    parameter of the port (RPN conv, both stages' FCs, the FPN's extra
    conv), equal to the tree."""
    jm, v, _ = _pair("roitrans")
    path = tmp_path / "roitrans.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, v), f)
    port = reg.build_from_cfg(tiny_model("roitrans"), reg.MODELS)
    load_jax_variables(port, load_jax_checkpoint(str(path)))
    sd = port.state_dict()
    p = v["params"]
    pairs = [("rpn.rpn_conv.weight", p["_rpn"]["rpn_conv"]["kernel"]
              .transpose(3, 2, 0, 1)),
             ("neck.extra_conv_0.weight", p["_neck"]["extra_conv_0"]
              ["kernel"].transpose(3, 2, 0, 1))]
    for st in ("stage1", "stage2"):
        for fc in ("fc0", "fc1", "fc_cls", "fc_reg"):
            node = p["_bbox_head"][st][fc]
            pairs += [(f"bbox_head.{st}.{fc}.weight", node["kernel"].T),
                      (f"bbox_head.{st}.{fc}.bias", node["bias"])]
    for name, want in pairs:
        np.testing.assert_array_equal(sd[name].numpy(), want)


def test_make_targets_carries_hboxes():
    """``make_targets`` gives each box its enclosing hbb, without a draw
    of its own (the other targets are those of the same seed)."""
    t = make_targets(2, 256, 8, torch.Generator().manual_seed(4))
    ref = JB.obb2hbb(t["rboxes"].numpy())
    assert t["hboxes"].shape == (2, 8, 4)
    np.testing.assert_allclose(t["hboxes"].numpy(), ref, rtol=1e-6,
                               atol=1e-4)
    again = make_targets(2, 256, 8, torch.Generator().manual_seed(4))
    assert torch.equal(again["labels"], t["labels"])
