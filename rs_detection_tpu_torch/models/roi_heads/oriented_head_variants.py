"""``OrientedHead`` with another classification loss (counterpart of
``rs_detection_tpu/models/roi_heads/oriented_head_variants.py``):
``OrientedBCEHead``, ``OrientedDiceHead``, ``OrientedEFLHead`` and
``OrientedEQLv2Head``.

As in the JAX package, ``OrientedBCEHead`` and ``OrientedDiceHead`` train
the base head's cross-entropy (the BCE head's ``cls_loss`` is there but
its ``loss`` does not call it), and every variant serves the base head's
softmax. The EFL and EQLv2 heads swap the classification term for their
stateful loss. Its running statistics, the JAX ``loss_state``
collection, are buffers of the head's ``efl`` submodule, so they travel
with ``state_dict`` and checkpoints, and each training step moves them
once. The JAX EFL and EQLv2 heads' ``loss`` cannot run (flax refuses its
``self.variable`` outside ``setup`` and ``@compact``): these do what it
means to do.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import HEADS
from ..losses.common import binary_cross_entropy
from ..losses.long_tail import EQLv2, EqualizedFocalLoss
from .oriented_head import OrientedHead


class LossState(nn.Module):
    """A stateful loss's state (a NamedTuple of tensors) as buffers named
    by its fields. ``advance`` installs a step's new state.

    Under ``torch.utils.checkpoint`` a step's forward runs again in its
    backward: ``recomputing()`` (the recompute context of
    ``checkpoint_contexts``) shows that forward the state the step read,
    and keeps it from moving the state a second time.

    Its JAX counterpart is a variable of the ``loss_state`` collection,
    which a JAX tree lacks (the JAX heads would create it in ``loss``):
    loading such a tree keeps the initial state here."""

    JAX_COLLECTION = "loss_state"

    def __init__(self, state: NamedTuple):
        super().__init__()
        self.state_type = type(state)
        for k, v in state._asdict().items():
            self.register_buffer(k, v.clone())
        self.update = True
        self._read = None

    def value(self) -> NamedTuple:
        return self.state_type(*(getattr(self, k).clone()
                                 for k in self.state_type._fields))

    @torch.no_grad()
    def _set(self, values):
        for k, v in zip(self.state_type._fields, values):
            getattr(self, k).copy_(v)

    def advance(self, new: NamedTuple) -> None:
        if self.update:
            self._read = self.value()
            self._set(new)

    @contextlib.contextmanager
    def recomputing(self):
        now = self.value()
        self._set(self._read)
        self.update = False
        try:
            yield
        finally:
            self.update = True
            self._set(now)


@HEADS.register_module()
class OrientedBCEHead(OrientedHead):
    """Sigmoid BCE over one-hot labels of C + 1 channels (background
    last) in ``cls_loss``; ``loss`` is the base head's."""

    def cls_loss(self, cls_score, labels, label_weights, avg_factor):
        onehot = F.one_hot(labels, self.num_classes + 1).to(cls_score.dtype)
        return binary_cross_entropy(
            cls_score, onehot, label_weights[:, None],
            avg_factor=avg_factor * cls_score.shape[-1])


@HEADS.register_module()
class OrientedDiceHead(OrientedHead):
    """The base head (the JAX variant adds nothing to it)."""


@HEADS.register_module()
class OrientedEFLHead(OrientedHead):
    """Equalized focal loss on the C + 1 channels, its state in ``efl``."""

    def setup_loss(self):
        self.cls_loss_fn = EqualizedFocalLoss(num_classes=self.num_classes + 1)
        self.efl = LossState(self.cls_loss_fn.init_state())

    def loss(self, feats, proposals, prop_valid, targets, generator):
        """The base head's sampling and bbox loss; the classification term
        is the stateful loss over every slot (no label weights), and the
        state moves by this step's statistics."""
        sampled, cls_score, bbox_pred = self.forward_sampled(
            feats, proposals, prop_valid, targets, generator)
        loss_cls, new_state = self.cls_loss_fn(
            cls_score, sampled["labels"].reshape(-1), self.efl.value())
        self.efl.advance(new_state)
        return dict(loss_cls=loss_cls,
                    orcnn_bbox_loss=self.bbox_loss(sampled, bbox_pred))

    def checkpoint_contexts(self):
        """``torch.utils.checkpoint`` contexts (forward, recompute) for a
        checkpointed ``loss``: the recomputed forward reads the step's
        state and leaves it alone."""
        return contextlib.nullcontext(), self.efl.recomputing()


@HEADS.register_module()
class OrientedEQLv2Head(OrientedEFLHead):
    """EQLv2 on C classes + the background channel, its state in
    ``efl``."""

    def setup_loss(self):
        self.cls_loss_fn = EQLv2(num_classes=self.num_classes)
        self.efl = LossState(self.cls_loss_fn.init_state())
