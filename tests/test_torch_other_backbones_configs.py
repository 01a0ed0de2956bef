"""The registered names of the other backbones (ConvNeXt, LSKNet, Res2Net,
SK2Res2Net, Swin and the jimm scope) in the port against the JAX package:
each constructor builds on the meta device with the JAX parameter and
BatchNorm-statistic counts, the ``van_*`` aliases are ``van_b*``, every
unported jimm name raises JAX's message, the two registries hold the
same names, the two detectors of the full-width runs build with the JAX
networks' counts, and the ConvNeXt config's faults are JAX's. CPU."""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

import rs_detection_tpu.models  # noqa: F401  (fills the JAX registries)
from rs_detection_tpu.config.config import Config as JConfig
from rs_detection_tpu.models.backbones import jimm_scope as jjimm
from rs_detection_tpu.utils import registry as jreg
from rs_detection_tpu_torch.config.config import Config
from rs_detection_tpu_torch.models.backbones import jimm_scope
from rs_detection_tpu_torch.runner import runner  # noqa: F401  (registries)
from rs_detection_tpu_torch.utils import registry as reg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONVNEXT_CFG = os.path.join(REPO, "projects", "roi_transformer", "configs",
                            "RoITrans_convnext_xlarge_5e-5.py")
LSKNET_CFG = os.path.join(REPO, "configs", "orcnn_van3_fair1m_1_5.py")

# (flax params, batch_stats) of each name, from ``jax.eval_shape`` of its
# init on a 256^2 input; the two window-12 Swins on a 384^2 one. Flax
# makes a Swin block's bias table at min(window, map side): on 256^2
# Swin-L-384's stage 4 (8^2) takes 15^2-row tables, 195,172,020
# parameters in all; the port holds the whole window's table, as JAX
# does from 384^2 on (``models/backbones/swin.py``).
COUNTS = {
    "ConvNeXt": (27821472, 0), "convnext_tiny": (27821472, 0),
    "convnext_small": (49456032, 0), "convnext_base": (87568256, 0),
    "convnext_large": (196233024, 0), "convnext_xlarge": (348151552, 0),
    "LSKNet": (13840892, 12800), "lsknet_t": (3990190, 7424),
    "lsknet_s": (13840892, 12800),
    "Res2Net": (23669352, 59620), "res2net50_v1b": (23669352, 59620),
    "res2net101_v1b": (43176920, 119188),
    "SK2Res2Net": (44781081, 122652),
    "sk2res2net101_v1b": (44781081, 122652),
    "Swin": (27520698, 0), "swin_tiny": (27520698, 0),
    "swin_small": (48838602, 0), "swin_base": (86745016, 0),
    "swin_base_patch4_window12_384_in22k": (86880376, 0),
    "swin_large_patch4_window12_384_in22k": (195201204, 0),
    "van_tiny": (3848800, 7424), "van_small": (13348800, 12800),
    "van_base": (26065472, 25856), "van_large": (44252608, 46080),
}
VAN_ALIASES = {"van_tiny": "van_b0", "van_small": "van_b1",
               "van_base": "van_b2", "van_large": "van_b3"}
SAMPLE = ("volo_d1", "deit_tiny_patch16_224", "efficientnet_b0",
          "hrnet_w18", "resnet50", "tf_efficientnetv2_s",
          "vit_base_patch16_224", "wide_resnet50_2")


def _counts(module):
    params = sum(p.numel() for p in module.parameters())
    stats = sum(b.numel() for n, b in module.named_buffers()
                if not n.endswith("num_batches_tracked"))
    return params, stats


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_name_builds_with_the_jax_counts(name):
    """The 20 constructors of item 12's files and the jimm scope, and the
    4 ``van_*`` aliases; the functions drop ``pretrained`` as JAX's do
    (the classes take no such key, as the flax modules)."""
    extra = {} if name[0].isupper() else dict(pretrained=True)
    with torch.device("meta"):
        m = reg.build_from_cfg(dict(type=name, **extra), reg.BACKBONES)
    assert _counts(m) == COUNTS[name]


def test_the_window12_swin_counts_are_jax_at_384():
    """The Swin-L-384 count against JAX's ``eval_shape`` on a 384^2 input
    (every stage's map at least the window) and on 256^2 (stage 4 of 8^2:
    smaller tables, 29,184 parameters fewer)."""
    jm = jreg.build_from_cfg(dict(type="swin_large_patch4_window12_384_in22k"),
                             jreg.BACKBONES)

    def count(side):
        v = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, side, side, 3)))
        return sum(int(a.size) for a in jax.tree_util.tree_leaves(v))

    assert count(384) == COUNTS["swin_large_patch4_window12_384_in22k"][0]
    assert count(256) == 195172020


@pytest.mark.parametrize("alias", sorted(VAN_ALIASES))
def test_van_alias_is_van_b(alias):
    """The alias builds the VAN its arch names, parameter for parameter,
    and takes ``van_b*``'s weights."""
    a = reg.build_from_cfg(dict(type=alias), reg.BACKBONES)
    b = reg.build_from_cfg(dict(type=VAN_ALIASES[alias]), reg.BACKBONES)
    assert type(a) is type(b) and a.depths == b.depths
    sa, sb = a.state_dict(), b.state_dict()
    assert {k: v.shape for k, v in sa.items()} == \
        {k: v.shape for k, v in sb.items()}
    a.load_state_dict(sb)


def test_unported_jimm_names_are_jax_names():
    """The port's copy of ``UNPORTED_JIMM_MODELS`` is JAX's, and the same
    names are registered as raising constructors in both."""
    assert jimm_scope.UNPORTED_JIMM_MODELS == jjimm.UNPORTED_JIMM_MODELS
    assert jimm_scope._SCOPE_MSG == jjimm._SCOPE_MSG

    def stubs(registry):
        return {n for n in jjimm.UNPORTED_JIMM_MODELS
                if registry.get(n).__qualname__.startswith("_make_stub")}

    assert stubs(reg.BACKBONES) == stubs(jreg.BACKBONES)
    assert len(stubs(reg.BACKBONES)) == 256


@pytest.mark.parametrize("name", SAMPLE)
def test_unported_jimm_name_raises_the_jax_message(name):
    with pytest.raises(NotImplementedError) as port:
        reg.build_from_cfg(dict(type=name, pretrained=True), reg.BACKBONES)
    with pytest.raises(NotImplementedError) as ref:
        jreg.build_from_cfg(dict(type=name, pretrained=True), jreg.BACKBONES)
    assert str(port.value) == str(ref.value)
    assert f"jimm backbone '{name}' is intentionally not ported" in \
        str(port.value)


def test_the_registries_hold_the_same_backbones():
    """Every JAX backbone name is registered in the port, and no other."""
    assert set(reg.BACKBONES.modules) == set(jreg.BACKBONES.modules)


@pytest.mark.parametrize("path,section,count", [
    (LSKNET_CFG, dict(type="lsknet_s", pretrained=True), 30979133),
    (CONVNEXT_CFG, dict(type="convnext_xlarge", pretrained=True),
     379911981)], ids=["lsknet_s_orcnn", "convnext_xlarge_roitrans"])
def test_full_width_detector_builds_with_the_jax_count(path, section, count):
    """The two networks of ``chip_smoke.py`` phases 52-53: Oriented R-CNN
    on LSKNet-S (the VAN-b3 config's FPN fits its widths) and the ConvNeXt
    config with the backbone section JAX can build; the JAX networks'
    parameter counts (``jax.eval_shape`` at 256^2)."""
    model = Config(path).model
    model["backbone"] = dict(section)
    with torch.device("meta"):
        m = reg.build_from_cfg(model, reg.MODELS)
    assert sum(p.numel() for p in m.parameters()) == count


@pytest.mark.parametrize("key,value", [("frozen_stages", 1),
                                       ("return_stages", ["layer1"])])
def test_convnext_takes_no_resnet_keys_like_jax(key, value):
    """The ConvNeXt config's backbone section fails twice in JAX (ROADMAP,
    Queue 3): its type is unregistered, and with the type fixed, its
    ``frozen_stages`` and ``return_stages`` are ResNet's keys, which
    ``ConvNeXt`` does not take. The port raises the same ``TypeError``."""
    section = dict(type="convnext_xlarge", pretrained=True, **{key: value})
    with pytest.raises(TypeError, match=f"unexpected keyword argument "
                       f"'{key}'"):
        jreg.build_from_cfg(dict(section), jreg.BACKBONES)
    with pytest.raises(TypeError, match=f"unexpected keyword argument "
                       f"'{key}'"):
        reg.build_from_cfg(dict(section), reg.BACKBONES)
    assert Config(CONVNEXT_CFG).model["backbone"][key] == (
        JConfig(CONVNEXT_CFG).model["backbone"][key])
