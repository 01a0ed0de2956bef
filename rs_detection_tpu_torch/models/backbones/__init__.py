"""The port's backbones; importing the package registers them (VAN and
``van_b0``-``van_b3``; ``ResNet``, ``Resnet{18,26,34,38,50,101,152}`` and
``Resnet{50,101}_v1d``; SSD's ``SSDVGG`` and ``SSD_VGG16``). The
ConvNeXt names (the JAX package's, and the ``Convnext_xlarge`` of
``projects/roi_transformer``) raise, naming their ROADMAP item."""

from ...utils.registry import BACKBONES, register_unported
from . import resnet, ssd_vgg, van  # noqa: F401

register_unported(BACKBONES, (
    "ConvNeXt", "convnext_tiny", "convnext_small", "convnext_base",
    "convnext_large", "convnext_xlarge", "Convnext_xlarge"),
    "the backbone", "12")
