"""Activations (counterpart of ``rs_detection_tpu/ops/activations.py``)."""

from __future__ import annotations

import torch.nn.functional as F


def exact_gelu(x):
    """Exact erf GELU. The JAX package evaluates erf with the
    Abramowitz-Stegun 7.1.26 polynomial (within 1.5e-7 of it) because
    Mosaic lowers no erf; PyTorch has the exact one, computed in f32
    for bf16 inputs and rounded once, as the JAX form is."""
    return F.gelu(x, approximate="none")
