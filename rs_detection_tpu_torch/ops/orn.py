"""Oriented Response Networks (counterpart of
``rs_detection_tpu/ops/orn.py``): the Active Rotating Filter as a static
gather of the weight, rotation-invariant pooling and encoding. Plain
PyTorch; the index tables are host numpy, equal to the JAX package's.
Autograd gives the ARF's backward (the reference's scatter-sum)."""

from __future__ import annotations

import math

import numpy as np
import torch

# Rotation index tables for 1x1 and 3x3 kernels (1-based spatial cell
# indices after rotating the kernel by each multiple of 45 degrees).
_KERNEL_INDICES = {
    1: {
        0: (1,), 45: (1,), 90: (1,), 135: (1,),
        180: (1,), 225: (1,), 270: (1,), 315: (1,),
    },
    3: {
        0: (1, 2, 3, 4, 5, 6, 7, 8, 9),
        45: (2, 3, 6, 1, 5, 9, 4, 7, 8),
        90: (3, 6, 9, 2, 5, 8, 1, 4, 7),
        135: (6, 9, 8, 3, 5, 7, 2, 1, 4),
        180: (9, 8, 7, 6, 5, 4, 3, 2, 1),
        225: (8, 7, 4, 9, 5, 1, 6, 3, 2),
        270: (7, 4, 1, 8, 5, 2, 9, 6, 3),
        315: (4, 1, 2, 7, 5, 3, 8, 9, 6),
    },
}


def arf_indices(n_orientation: int, n_rotation: int, k: int) -> np.ndarray:
    """Forward scatter table: entry (l, r) gives the 1-based destination
    slot of source slot ``l`` under rotation ``r``
    (reference ``orn.py:644-680``)."""
    d_or = 360.0 / n_orientation
    d_rot = 360.0 / n_rotation
    n_entry = n_orientation * k * k
    table = np.zeros((n_entry, n_rotation), np.int64)
    for i in range(n_orientation):
        for j in range(k * k):
            for r in range(n_rotation):
                angle = int(d_rot * r)
                layer = (i + int(math.floor(angle / d_or))) % n_orientation
                cell = _KERNEL_INDICES[k][angle][j]
                table[i * k * k + j, r] = layer * k * k + cell
    return table


def arf_gather_indices(n_orientation: int, n_rotation: int,
                       k: int) -> np.ndarray:
    """Inverse permutation [nRotation, nEntry]: for each rotation, the
    source slot feeding each destination slot: the reference's scatter
    kernel as a static gather."""
    fwd = arf_indices(n_orientation, n_rotation, k)  # [nEntry, nRot]
    n_entry = fwd.shape[0]
    inv = np.zeros((n_rotation, n_entry), np.int64)
    for r in range(n_rotation):
        inv[r, fwd[:, r] - 1] = np.arange(n_entry)
    return inv


def active_rotating_filter(weight, gather_idx):
    """[Cout, Cin, nOrientation * k * k] ARF weight and the
    [nRotation, nEntry] table of ``arf_gather_indices`` -> [Cout *
    nRotation, Cin, nEntry] rotated copies, o-major (``out[o * nRot + r]``
    is rotation r of ``weight[o]``, the reference's ``arf_forward``
    layout)."""
    cout, cin, n_entry = weight.shape
    idx = torch.as_tensor(gather_idx, device=weight.device)
    n_rot = idx.shape[0]
    rotated = weight[:, :, idx.reshape(-1)].reshape(cout, cin, n_rot, n_entry)
    return rotated.permute(0, 2, 1, 3).reshape(cout * n_rot, cin, n_entry)


def rotation_invariant_pooling(x, n_orientation: int = 8):
    """Max over orientation groups of the last (channel) axis: [..., C]
    -> [..., C / nOr], channel ``g * nOr + o`` in group g (the
    reference's NCHW ``view(N, C / nOr, nOr, H, W)``)."""
    return x.unflatten(-1, (x.shape[-1] // n_orientation,
                            n_orientation)).amax(-1)


def rotation_invariant_encoding(x, n_orientation: int = 8):
    """Each group of [N, C] features (C = nFeature * nOrientation)
    circularly shifted so that its strongest orientation comes first
    (reference ``rie_forward``) -> (aligned [N, C], main direction [N,
    nFeature]); ties go to the first orientation, as ``jnp.argmax``."""
    n, c = x.shape
    g = x.reshape(n, c // n_orientation, n_orientation)
    main = g.argmax(-1)
    idx = (main[..., None] + torch.arange(n_orientation, device=x.device)) \
        % n_orientation
    return g.gather(-1, idx).reshape(n, c), main
