"""The PyTorch port's Oriented R-CNN inference slice against the JAX
package: the tiny config built in both frameworks with the same
weights (JAX ``model.init``, perturbed, carried across by
``load_jax_variables``) and the same seeded input, CPU, f32."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rs_detection_tpu.models.backbones.van import VAN
from rs_detection_tpu.models.necks.fpn import FPN
from rs_detection_tpu.models.networks.rcnn import OrientedRCNN
from rs_detection_tpu.models.roi_heads.oriented_head import OrientedHead
from rs_detection_tpu.models.roi_heads.oriented_rpn_head import OrientedRPNHead
from rs_detection_tpu_torch.flagship import build_flagship, normalize
from rs_detection_tpu_torch.utils.jax_weights import (jax_to_state_dict,
                                                      load_jax_variables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_tiny():
    """The JAX twin of ``build_flagship(tiny=True)``."""
    dims = (16, 32, 40, 64)
    return OrientedRCNN(
        backbone=VAN(embed_dims=dims, mlp_ratios=(8, 8, 4, 4),
                     depths=(1, 1, 2, 1)),
        neck=FPN(in_channels=dims, out_channels=32, num_outs=5),
        rpn=OrientedRPNHead(
            in_channels=32, feat_channels=32,
            anchor_generator=dict(
                scales=[8], ratios=[0.125, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0],
                strides=[4, 8, 16, 32, 64]),
            nms_pre=256, nms_post=64, pre_nms_cap=512),
        bbox_head=OrientedHead(
            num_classes=10, in_channels=32, fc_out_channels=64,
            bbox_roi_extractor=dict(
                roi_layer=dict(output_size=7, sampling_ratio=2),
                out_channels=32, extend_factor=(1.4, 1.2),
                featmap_strides=[4, 8, 16, 32])))


def perturb(variables, seed):
    """Non-trivial biases, BN stats and layer scales (init makes them
    0 / 1 / 1e-2, which would hide a mapping error)."""
    rng = np.random.RandomState(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
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


@pytest.fixture(scope="module")
def tiny_pair():
    model = jax_tiny()
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    variables = jax.jit(lambda i: model.init(
        {"params": jax.random.PRNGKey(0)}, i))(x)
    variables = perturb(variables, seed=3)
    port = build_flagship(tiny=True, device="cpu")
    load_jax_variables(port, variables)
    return model, variables, port


def test_bridge_covers_every_tensor(tiny_pair):
    _, variables, port = tiny_pair
    names = set(jax_to_state_dict(variables))
    expected = {k for k in port.state_dict()
                if not k.endswith("num_batches_tracked")}
    assert names == expected


def test_bridge_rejects_missing_and_misshapen(tiny_pair):
    _, variables, _ = tiny_pair
    port = build_flagship(tiny=True, device="cpu")
    short = {c: dict(t) for c, t in variables.items()}
    short["params"] = {k: v for k, v in short["params"].items()
                       if k != "rpn"}
    with pytest.raises(ValueError, match="missing"):
        load_jax_variables(port, short)
    bad = perturb(variables, seed=4)
    bad["params"]["rpn"]["rpn_cls"]["bias"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="wrong shapes"):
        load_jax_variables(port, bad)


def test_tiny_predict_matches_jax(tiny_pair):
    """``OrientedRCNN.predict`` at batch 2, 128^2. Tolerances: both
    sides are f32 on the CPU, so module outputs agree to ~1e-5 relative
    (convolution summation order, and the JAX GELU's 1.5e-7 erf
    polynomial). Measured: 5e-5 px on polys of up to ~200 px, 1e-7 on
    scores; the bounds leave 10-20x of that (atol 1e-3 px, 2e-6)."""
    model, variables, port = tiny_pair
    rng = np.random.RandomState(11)
    tiles = rng.randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    images = normalize(torch.from_numpy(tiles))
    got = port.predict(images)
    ref = jax.jit(lambda v, i: model.apply(v, i, method=model.predict))(
        variables, jnp.asarray(images.numpy()))
    valid = np.asarray(ref["valid"])
    assert valid.sum() > 32  # a real proposal set, not padding
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(ref["scores"]), atol=2e-6)
    np.testing.assert_allclose(got["polys"].numpy(),
                               np.asarray(ref["polys"]), atol=1e-3)
    assert got["scores"].std() > 1e-3  # the head is not degenerate


def test_port_imports_no_jax():
    """The package, the tiny model's predict and its training step
    never pull in jax or flax."""
    code = ("import pkgutil, importlib, sys, torch\n"
            "import rs_detection_tpu_torch as pkg\n"
            "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "from rs_detection_tpu_torch.flagship import (build_flagship,\n"
            "                                            make_targets)\n"
            "from rs_detection_tpu_torch.optims.lr_scheduler import StepLR\n"
            "from rs_detection_tpu_torch.optims.optimizer import AdamW\n"
            "from rs_detection_tpu_torch.parallel.train_step import "
            "train_step\n"
            "m = build_flagship(tiny=True, device='cpu')\n"
            "m.predict(torch.zeros(1, 64, 64, 3))\n"
            "m = build_flagship(tiny=True, device='cpu', train=True)\n"
            "g = torch.Generator().manual_seed(0)\n"
            "train_step(m, AdamW(m.parameters()), StepLR([7, 10]),\n"
            "           torch.zeros(1, 64, 64, 3), make_targets(1, 64, 4, g),"
            " g, epoch=0)\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in\n"
            "       ('jax', 'flax', 'rs_detection_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
