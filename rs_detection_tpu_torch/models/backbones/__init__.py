"""The port's backbones; importing the package registers them (VAN and
``van_b0``-``van_b3``; ``ResNet``, ``Resnet{18,26,34,38,50,101,152}`` and
``Resnet{50,101}_v1d``)."""

from . import resnet, van  # noqa: F401
