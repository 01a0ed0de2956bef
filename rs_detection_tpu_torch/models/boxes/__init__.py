"""The box toolbox. Importing it fills ``BOXES`` with the anchor
generators, assigners, coders, IoU calculators and samplers by name, as
the JAX package's ``models/boxes/__init__.py`` does, so that a config
may name any of them before its family's module is imported."""

from . import (anchor_generator, anchor_target, assigner,  # noqa: F401
               coder, iou_calculator, sampler)
