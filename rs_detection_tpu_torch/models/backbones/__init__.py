"""The port's backbones; importing the package registers them, in the
JAX package's order: ConvNeXt (``convnext_tiny`` .. ``convnext_xlarge``),
the jimm scope (``van_tiny`` .. ``van_large``, the two Swin-384 forms,
the unported jimm names, which raise), LSKNet (``lsknet_t``,
``lsknet_s``), ``Res2Net`` (``res2net{50,101}_v1b``), ResNet
(``Resnet{18,26,34,38,50,101,152}``, ``Resnet{50,101}_v1d``),
``SK2Res2Net`` (``sk2res2net101_v1b``), SSD's ``SSDVGG`` and
``SSD_VGG16``, Swin (``swin_tiny``, ``swin_small``, ``swin_base``) and
VAN (``van_b0`` .. ``van_b3``)."""

from . import (convnext, jimm_scope, lsknet, res2net, resnet,  # noqa: F401
               sk2res2net, ssd_vgg, swin, van)
