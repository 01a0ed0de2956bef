"""The jimm backbone-library scope (counterpart of
``rs_detection_tpu/models/backbones/jimm_scope.py``). The reference
bundles ``jimm``, a Jittor port of timm with 257 classifier
architectures; the configs reach only VAN and the two Swin-384 variants.
So, as in JAX:

* the jimm names whose architectures are ported are aliases:
  ``van_tiny`` .. ``van_large`` -> ``van_b0`` .. ``van_b3``, and the two
  ``swin_*_patch4_window12_384_in22k`` names -> ``Swin`` configurations;
* every other jimm name (``UNPORTED_JIMM_MODELS``, the port's own copy of
  the JAX tuple) is registered with a constructor that raises
  ``NotImplementedError`` with the JAX package's message.
"""

from __future__ import annotations

from ...utils.registry import BACKBONES
from .swin import Swin
from .van import _VAN_ARCH, VAN

_SCOPE_MSG = (
    "jimm backbone '{name}' is intentionally not ported: it belongs to "
    "the reference's bundled 13.4k-LoC timm library of which no shipped "
    "config reaches this member (SURVEY §2.5). Supported backbone "
    "families: ResNet/Resnet18..152(+v1d), van_b0..b3 (aliases "
    "van_tiny/small/base/large), Res2Net, SK2Res2Net, Swin "
    "(+swin_tiny/small/base and the two *_window12_384_in22k variants), "
    "ConvNeXt, LSKNet, SSD-VGG, CSPDarknet. If you need '{name}', port "
    "its architecture natively and register it in BACKBONES."
)


def _make_van_alias(arch):
    def build(pretrained=False, **kw):
        return VAN(**{**_VAN_ARCH[arch], **kw})

    build.__name__ = arch
    return build


for _alias, _arch in (("van_tiny", "van_b0"), ("van_small", "van_b1"),
                      ("van_base", "van_b2"), ("van_large", "van_b3")):
    BACKBONES.register_module(name=_alias, module=_make_van_alias(_arch))


@BACKBONES.register_module(name="swin_base_patch4_window12_384_in22k")
def _swin_base_384(pretrained=False, **kw):
    return Swin(embed_dim=128, depths=(2, 2, 18, 2),
                num_heads=(4, 8, 16, 32), window_size=12, **kw)


@BACKBONES.register_module(name="swin_large_patch4_window12_384_in22k")
def _swin_large_384(pretrained=False, **kw):
    return Swin(embed_dim=192, depths=(2, 2, 18, 2),
                num_heads=(6, 12, 24, 48), window_size=12, **kw)


# every remaining jimm register_model name (reference jimm/models/*.py)
UNPORTED_JIMM_MODELS = (
    # volo.py ships volo_d1..d5 as plain constructors (no decorator)
    "volo_d1", "volo_d2", "volo_d3", "volo_d4", "volo_d5",
    "deit_base_distilled_patch16_224", "deit_base_distilled_patch16_384",
    "deit_base_patch16_224", "deit_base_patch16_384",
    "deit_small_distilled_patch16_224", "deit_small_patch16_224",
    "deit_tiny_distilled_patch16_224", "deit_tiny_patch16_224",
    "ecaresnet101d", "ecaresnet101d_pruned", "ecaresnet200d",
    "ecaresnet269d", "ecaresnet26t", "ecaresnet50d", "ecaresnet50d_pruned",
    "ecaresnet50t", "ecaresnetlight", "ecaresnext26t_32x4d",
    "ecaresnext50t_32x4d", "efficientnet_b0", "efficientnet_b1",
    "efficientnet_b1_pruned", "efficientnet_b2", "efficientnet_b2_pruned",
    "efficientnet_b2a", "efficientnet_b3", "efficientnet_b3_pruned",
    "efficientnet_b3a", "efficientnet_b4", "efficientnet_b5",
    "efficientnet_b6", "efficientnet_b7", "efficientnet_b8",
    "efficientnet_cc_b0_4e", "efficientnet_cc_b0_8e",
    "efficientnet_cc_b1_8e", "efficientnet_el", "efficientnet_em",
    "efficientnet_es", "efficientnet_l2", "efficientnet_lite0",
    "efficientnet_lite1", "efficientnet_lite2", "efficientnet_lite3",
    "efficientnet_lite4", "fbnetc_100", "hrnet_w18", "hrnet_w18_small",
    "hrnet_w18_small_v2", "hrnet_w30", "hrnet_w32", "hrnet_w40",
    "hrnet_w44", "hrnet_w48", "hrnet_w64", "ig_resnext101_32x16d",
    "ig_resnext101_32x32d", "ig_resnext101_32x48d", "ig_resnext101_32x8d",
    "mixnet_l", "mixnet_m", "mixnet_s", "mixnet_xl", "mixnet_xxl",
    "mnasnet_050", "mnasnet_075", "mnasnet_100", "mnasnet_140",
    "mnasnet_a1", "mnasnet_b1", "mnasnet_small", "mobilenetv2_100",
    "mobilenetv2_110d", "mobilenetv2_120d", "mobilenetv2_140", "resnet101",
    "resnet101d", "resnet152", "resnet152d", "resnet18", "resnet18d",
    "resnet200", "resnet200d", "resnet26", "resnet26d", "resnet34",
    "resnet34d", "resnet50", "resnet50d", "resnetblur18", "resnetblur50",
    "resnetv2_101x1_bitm", "resnetv2_101x1_bitm_in21k",
    "resnetv2_101x3_bitm", "resnetv2_101x3_bitm_in21k",
    "resnetv2_152x2_bit_teacher", "resnetv2_152x2_bit_teacher_384",
    "resnetv2_152x2_bitm", "resnetv2_152x2_bitm_in21k",
    "resnetv2_152x4_bitm", "resnetv2_152x4_bitm_in21k", "resnetv2_50",
    "resnetv2_50d", "resnetv2_50x1_bit_distilled", "resnetv2_50x1_bitm",
    "resnetv2_50x1_bitm_in21k", "resnetv2_50x3_bitm",
    "resnetv2_50x3_bitm_in21k", "resnext101_32x4d", "resnext101_32x8d",
    "resnext101_64x4d", "resnext50_32x4d", "resnext50d_32x4d",
    "semnasnet_050", "semnasnet_075", "semnasnet_100", "semnasnet_140",
    "senet154", "seresnet101", "seresnet152", "seresnet152d", "seresnet18",
    "seresnet200d", "seresnet269d", "seresnet34", "seresnet50",
    "seresnet50t", "seresnext101_32x4d", "seresnext101_32x8d",
    "seresnext26d_32x4d", "seresnext26t_32x4d", "seresnext26tn_32x4d",
    "seresnext50_32x4d", "spnasnet_100", "ssl_resnet18", "ssl_resnet50",
    "ssl_resnext101_32x16d", "ssl_resnext101_32x4d",
    "ssl_resnext101_32x8d", "ssl_resnext50_32x4d", "swsl_resnet18",
    "swsl_resnet50", "swsl_resnext101_32x16d", "swsl_resnext101_32x4d",
    "swsl_resnext101_32x8d", "swsl_resnext50_32x4d", "tf_efficientnet_b0",
    "tf_efficientnet_b0_ap", "tf_efficientnet_b0_ns", "tf_efficientnet_b1",
    "tf_efficientnet_b1_ap", "tf_efficientnet_b1_ns", "tf_efficientnet_b2",
    "tf_efficientnet_b2_ap", "tf_efficientnet_b2_ns", "tf_efficientnet_b3",
    "tf_efficientnet_b3_ap", "tf_efficientnet_b3_ns", "tf_efficientnet_b4",
    "tf_efficientnet_b4_ap", "tf_efficientnet_b4_ns", "tf_efficientnet_b5",
    "tf_efficientnet_b5_ap", "tf_efficientnet_b5_ns", "tf_efficientnet_b6",
    "tf_efficientnet_b6_ap", "tf_efficientnet_b6_ns", "tf_efficientnet_b7",
    "tf_efficientnet_b7_ap", "tf_efficientnet_b7_ns", "tf_efficientnet_b8",
    "tf_efficientnet_b8_ap", "tf_efficientnet_cc_b0_4e",
    "tf_efficientnet_cc_b0_8e", "tf_efficientnet_cc_b1_8e",
    "tf_efficientnet_el", "tf_efficientnet_em", "tf_efficientnet_es",
    "tf_efficientnet_l2_ns", "tf_efficientnet_l2_ns_475",
    "tf_efficientnet_lite0", "tf_efficientnet_lite1",
    "tf_efficientnet_lite2", "tf_efficientnet_lite3",
    "tf_efficientnet_lite4", "tf_efficientnetv2_b0",
    "tf_efficientnetv2_b1", "tf_efficientnetv2_b2", "tf_efficientnetv2_b3",
    "tf_efficientnetv2_l", "tf_efficientnetv2_l_in21ft1k",
    "tf_efficientnetv2_l_in21k", "tf_efficientnetv2_m",
    "tf_efficientnetv2_m_in21ft1k", "tf_efficientnetv2_m_in21k",
    "tf_efficientnetv2_s", "tf_efficientnetv2_s_in21ft1k",
    "tf_efficientnetv2_s_in21k", "tf_mixnet_l", "tf_mixnet_m",
    "tf_mixnet_s", "tv_resnet101", "tv_resnet152", "tv_resnet34",
    "tv_resnet50", "tv_resnext50_32x4d", "vit_base_patch16_224",
    "vit_base_patch16_224_in21k", "vit_base_patch16_224_miil",
    "vit_base_patch16_224_miil_in21k", "vit_base_patch16_384",
    "vit_base_patch32_224", "vit_base_patch32_224_in21k",
    "vit_base_patch32_384", "vit_base_r26_s32_224", "vit_base_r50_s16_224",
    "vit_base_r50_s16_224_in21k", "vit_base_r50_s16_384",
    "vit_base_resnet26d_224", "vit_base_resnet50_224_in21k",
    "vit_base_resnet50_384", "vit_base_resnet50d_224",
    "vit_huge_patch14_224_in21k", "vit_large_patch16_224",
    "vit_large_patch16_224_in21k", "vit_large_patch16_384",
    "vit_large_patch32_224", "vit_large_patch32_224_in21k",
    "vit_large_patch32_384", "vit_large_r50_s32_224",
    "vit_large_r50_s32_224_in21k", "vit_large_r50_s32_384",
    "vit_small_patch16_224", "vit_small_patch16_224_in21k",
    "vit_small_patch16_384", "vit_small_patch32_224",
    "vit_small_patch32_224_in21k", "vit_small_patch32_384",
    "vit_small_r26_s32_224", "vit_small_r26_s32_224_in21k",
    "vit_small_r26_s32_384", "vit_small_resnet26d_224",
    "vit_small_resnet50d_s16_224", "vit_tiny_patch16_224",
    "vit_tiny_patch16_224_in21k", "vit_tiny_patch16_384",
    "vit_tiny_r_s16_p8_224", "vit_tiny_r_s16_p8_224_in21k",
    "vit_tiny_r_s16_p8_384", "wide_resnet101_2", "wide_resnet50_2",
)


def _make_stub(name):
    def unsupported(*args, **kwargs):
        raise NotImplementedError(_SCOPE_MSG.format(name=name))

    unsupported.__name__ = name
    return unsupported


for _name in UNPORTED_JIMM_MODELS:
    if _name not in BACKBONES:
        BACKBONES.register_module(name=_name, module=_make_stub(_name))
