"""Long-tail classification losses (counterpart of
``rs_detection_tpu/models/losses/long_tail.py``): ``SeesawLoss``,
``EQLv2``, ``EqualizedFocalLoss``, ``GroupSoftmax``, ``SoftDiceLoss``,
``EQLv2Impr`` and ``EqualizedFocalLossV1``.

The stateful ones keep running statistics (class counts, gradient sums)
that the reference mutates every step. As in the JAX package, each is a
plain function of its state, ``(cls_score, label, state) -> (loss,
new_state)``, with ``init_state(device)`` giving the first one; a state is
a NamedTuple of f32 tensors. The JAX losses sum their statistics over the
replicas of a data axis (``_maybe_psum``); the port runs one replica on
one card, where that sum is the identity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...parallel import dist
from ...utils.registry import LOSSES
from .common import weight_reduce_loss


def _one_hot(labels, n: int, dtype):
    """``jax.nn.one_hot``: a zero row for a label outside [0, n)."""
    return (labels[:, None] == torch.arange(n, device=labels.device)
            ).to(dtype)


def _reduce(loss, weight=None, reduction="mean", avg_factor=None):
    """The JAX ``weight_reduce_loss``, with its argument order
    (``common.weight_reduce_loss``: a count over the global batch under a
    process group)."""
    return weight_reduce_loss(loss, weight, avg_factor, reduction)


def sigmoid_bce(logits, labels):
    """BCE with logits in the JAX package's form (``optax_sigmoid_bce``)."""
    return logits.clamp(min=0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))


def _nll(logits, labels):
    return -torch.log_softmax(logits, -1).gather(1, labels[:, None])[:, 0]


# ---------------------------------------------------------------------------
# Seesaw
# ---------------------------------------------------------------------------

class SeesawState(NamedTuple):
    cum_samples: torch.Tensor  # [C + 2] cumulative per-class counts


def seesaw_ce_loss(cls_score, labels, label_weights, cum_samples,
                   num_classes, p=0.8, q=2.0, eps=1e-2, reduction="mean",
                   avg_factor=None):
    onehot = _one_hot(labels, num_classes, cls_score.dtype)
    weights = torch.ones_like(onehot)
    if p > 0:
        cs = cum_samples[:num_classes].clamp(min=1)
        ratio = cs[None, :] / cs[:, None]
        idx = (ratio < 1.0).to(cls_score.dtype)
        sw = ratio ** p * idx + (1 - idx)
        weights = weights * sw[labels]
    if q > 0:
        scores = torch.softmax(cls_score.detach(), 1)
        self_scores = scores.gather(1, labels[:, None])[:, 0]
        sm = scores / self_scores[:, None].clamp(min=eps)
        idx = (sm > 1.0).to(cls_score.dtype)
        weights = weights * (sm ** q * idx + (1 - idx))
    score = cls_score + torch.log(weights.clamp(min=1e-12)) * (1 - onehot)
    return _reduce(_nll(score, labels), label_weights, reduction, avg_factor)


@LOSSES.register_module()
class SeesawLoss:
    """Seesaw loss with the objectness split: C class logits + 2
    objectness logits (background last)."""

    def __init__(self, use_sigmoid=False, p=0.8, q=2.0, num_classes=15,
                 eps=1e-2, reduction="mean", loss_weight=1.0):
        assert not use_sigmoid
        self.p = p
        self.q = q
        self.num_classes = num_classes
        self.eps = eps
        self.reduction = reduction
        self.loss_weight = loss_weight

    def get_cls_channels(self, num_classes):
        return num_classes + 2

    def init_state(self, device=None) -> SeesawState:
        return SeesawState(torch.zeros(self.num_classes + 2, device=device))

    def split_cls_score(self, cls_score):
        return (cls_score[..., :self.num_classes],
                cls_score[..., self.num_classes:])

    def get_activation(self, cls_score):
        cls, obj = self.split_cls_score(cls_score)
        cls = torch.softmax(cls, -1)
        obj = torch.softmax(obj, -1)
        # foreground p(class) * p(object); background last
        return torch.cat([cls * obj[..., :1], obj[..., 1:]], -1)

    def __call__(self, cls_score, labels, state: SeesawState, weight=None,
                 avg_factor=None):
        """labels: 0-based foreground, ``num_classes`` for background."""
        cls_sc, obj_sc = self.split_cls_score(cls_score)
        pos = labels < self.num_classes
        obj_labels = (labels == self.num_classes).long()
        counts = dist.global_count(
            _one_hot(labels, self.num_classes + 2, torch.float32).sum(0))
        new_state = SeesawState(state.cum_samples + counts)
        posf = pos.float() * (1.0 if weight is None else weight)
        loss_cls = seesaw_ce_loss(
            cls_sc, torch.where(pos, labels, 0), posf,
            new_state.cum_samples, self.num_classes, self.p, self.q,
            self.eps, self.reduction,
            avg_factor if avg_factor is not None else pos.sum())
        loss_obj = _reduce(_nll(obj_sc, obj_labels), weight, self.reduction,
                           avg_factor)
        return self.loss_weight * (loss_cls + loss_obj), new_state


# ---------------------------------------------------------------------------
# EQLv2
# ---------------------------------------------------------------------------

class EQLv2State(NamedTuple):
    pos_grad: torch.Tensor
    neg_grad: torch.Tensor


def _gradient_sums(cls_score, target, w=None):
    """The detached |dBCE/dlogit| of each element, times ``w``, summed
    over the rows (of the global batch under a process group) for the
    positive and the negative targets."""
    prob = torch.sigmoid(cls_score.detach())
    grad = (target * (prob - 1) + (1 - target) * prob).abs()
    if w is not None:
        grad = grad * w.detach()
    return (dist.global_count((grad * target).sum(0)),
            dist.global_count((grad * (1 - target)).sum(0)))


@LOSSES.register_module()
class EQLv2:
    """Gradient-ratio balanced sigmoid loss; channels: C classes + 1
    objectness (last)."""

    def __init__(self, use_sigmoid=True, num_classes=1203, gamma=12, mu=0.8,
                 alpha=4.0, reduction="mean", loss_weight=1.0,
                 test_with_obj=True):
        self.num_classes = num_classes
        self.gamma = gamma
        self.mu = mu
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.test_with_obj = test_with_obj

    def get_channel_num(self, num_classes):
        return num_classes + 1

    def init_state(self, device=None) -> EQLv2State:
        return EQLv2State(
            torch.full((self.num_classes,), 1e-4, device=device),
            torch.full((self.num_classes,), 1e-4, device=device))

    def _map_func(self, x):
        return 1.0 / (1.0 + torch.exp(-self.gamma * (x - self.mu)))

    def get_activation(self, cls_score):
        s = torch.sigmoid(cls_score)
        if self.test_with_obj:
            bg = s[:, -1:]
            s = torch.cat([s[:, :-1] * (1 - bg), bg], 1)
        return s

    def _weights(self, pos_neg, target):
        neg_w = torch.cat([self._map_func(pos_neg), pos_neg.new_ones(1)])
        pos_w = 1 + self.alpha * (1 - neg_w)
        return pos_w[None] * target + neg_w[None] * (1 - target)

    def __call__(self, cls_score, label, state: EQLv2State, weight=None,
                 avg_factor=None):
        n_i, n_c = cls_score.shape
        target = _one_hot(label, n_c, cls_score.dtype)
        w = self._weights(state.pos_grad / state.neg_grad, target)
        loss = (sigmoid_bce(cls_score, target) * w).sum() / n_i
        pos_g, neg_g = _gradient_sums(cls_score, target, w)
        new_state = EQLv2State(state.pos_grad + pos_g[:-1],
                               state.neg_grad + neg_g[:-1])
        return self.loss_weight * loss, new_state


# ---------------------------------------------------------------------------
# EFL
# ---------------------------------------------------------------------------

class EFLState(NamedTuple):
    pos_grad: torch.Tensor
    neg_grad: torch.Tensor
    pos_neg: torch.Tensor


def _focal(cls_score, target, pos_neg, focal_gamma, focal_alpha,
           scale_factor):
    """The equalized focal loss summed over the elements, over the rows:
    a focal gamma per channel from its pos/neg gradient ratio."""
    n_i, n_c = cls_score.shape
    pred = torch.sigmoid(cls_score)
    pred_t = pred * target + (1 - pred) * (1 - target)
    ff = (focal_gamma + scale_factor * (1 - pos_neg))[None].expand(n_i, n_c)
    ff = ff.detach()
    ce = -torch.log(pred_t.clamp(min=1e-12))
    loss = ce * (1 - pred_t) ** ff * (ff / focal_gamma)
    if focal_alpha >= 0:
        loss = (focal_alpha * target + (1 - focal_alpha) * (1 - target)) \
            * loss
    return loss.sum() / n_i


@LOSSES.register_module()
class EqualizedFocalLoss:
    """Category-adaptive focal gamma, statistics over the ``num_classes``
    channels."""

    def __init__(self, use_sigmoid=True, num_classes=1203, focal_gamma=2.0,
                 focal_alpha=0.25, scale_factor=8.0, reduction="mean",
                 loss_weight=1.0, ignore_index=-1):
        self.num_classes = num_classes
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.scale_factor = scale_factor
        self.reduction = reduction
        self.loss_weight = loss_weight

    def init_state(self, device=None) -> EFLState:
        c = self.num_classes
        return EFLState(torch.zeros(c, device=device),
                        torch.zeros(c, device=device),
                        torch.ones(c, device=device))

    def __call__(self, cls_score, label, state: EFLState, weight=None,
                 avg_factor=None):
        n_c = cls_score.shape[1]
        target = _one_hot(label, n_c + 1, cls_score.dtype)[:, :-1]
        loss = _focal(cls_score, target, state.pos_neg, self.focal_gamma,
                      self.focal_alpha, self.scale_factor)
        pos_g, neg_g = _gradient_sums(cls_score, target)
        pos_grad = state.pos_grad + pos_g[:self.num_classes]
        neg_grad = state.neg_grad + neg_g[:self.num_classes]
        pos_neg = (pos_grad / neg_grad.clamp(min=1e-10)).clamp(0, 1)
        return self.loss_weight * loss, EFLState(pos_grad, neg_grad, pos_neg)


@LOSSES.register_module()
class GroupSoftmax:
    """Group-wise softmax: each group of classes gets its own softmax, its
    last slot the "other" logit (one group of all C + 1 channels, plain
    softmax CE, by default)."""

    def __init__(self, num_classes=15, groups=None, beta=8,
                 reduction="mean", loss_weight=1.0):
        self.num_classes = num_classes
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.groups = groups or [list(range(num_classes + 1))]

    def __call__(self, cls_score, label, weight=None, avg_factor=None):
        total = 0.0
        for g in self.groups:
            idx = torch.as_tensor(g, device=cls_score.device)
            in_group = torch.isin(label, idx)
            mapping = torch.zeros(cls_score.shape[1] + 1, dtype=torch.long,
                                  device=cls_score.device)
            mapping[idx] = torch.arange(len(g), device=cls_score.device)
            sub_label = torch.where(in_group, mapping[label], len(g) - 1)
            total = total + _reduce(_nll(cls_score[:, idx], sub_label),
                                    weight, self.reduction, avg_factor)
        return self.loss_weight * total


@LOSSES.register_module()
class SoftDiceLoss:
    """Soft dice over sigmoid scores."""

    def __init__(self, smooth=1.0, reduction="mean", loss_weight=1.0):
        self.smooth = smooth
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None):
        p = torch.sigmoid(pred)
        num = 2 * (p * target).sum(-1) + self.smooth
        den = p.sum(-1) + target.sum(-1) + self.smooth
        return self.loss_weight * _reduce(1 - num / den, weight,
                                          self.reduction, avg_factor)


# ---------------------------------------------------------------------------
# EQLv2Impr: EQLv2 with the classes reweighted by their share of the loss
# ---------------------------------------------------------------------------

class EQLv2ImprState(NamedTuple):
    pos_grad: torch.Tensor
    neg_grad: torch.Tensor
    acc_loss: torch.Tensor


@LOSSES.register_module()
class EQLv2Impr(EQLv2):
    """EQLv2 whose gradient statistics carry its pos/neg weights, and a
    weight per class ``1 / ((r / new_mu)^new_gamma + 1 / scale)`` from
    the class's accumulated share r of the loss."""

    def __init__(self, use_sigmoid=True, num_classes=1203, gamma=12, mu=0.8,
                 alpha=4.0, new_gamma=0.5, new_mu=0.08, scale_factor=10.0,
                 reduction="mean", loss_weight=1.0, test_with_obj=True, **kw):
        super().__init__(use_sigmoid=use_sigmoid, num_classes=num_classes,
                         gamma=gamma, mu=mu, alpha=alpha, reduction=reduction,
                         loss_weight=loss_weight, test_with_obj=test_with_obj)
        self.new_gamma = new_gamma
        self.new_mu = new_mu
        self.scale_factor = scale_factor

    def init_state(self, device=None) -> EQLv2ImprState:
        # pos / neg starts at 100, so both weights start at 1
        c = self.num_classes
        return EQLv2ImprState(torch.full((c,), 100.0, device=device),
                              torch.ones(c, device=device),
                              torch.full((c,), 1e-10, device=device))

    def _map_new_func(self, r):
        return 1.0 / ((r / self.new_mu) ** self.new_gamma
                      + 1.0 / self.scale_factor)

    def __call__(self, cls_score, label, state: EQLv2ImprState, weight=None,
                 avg_factor=None):
        n_i, n_c = cls_score.shape
        target = _one_hot(label, n_c, cls_score.dtype)
        w = self._weights(state.pos_grad / (state.neg_grad + 1e-10), target)
        ratios = state.acc_loss / state.acc_loss.sum()
        cls_weight = torch.cat([self._map_new_func(ratios),
                                ratios.new_ones(1)])
        imp_loss = (sigmoid_bce(cls_score, target) * w).sum(0) / n_i \
            * cls_weight
        pos_g, neg_g = _gradient_sums(cls_score, target, w)
        new_state = EQLv2ImprState(state.pos_grad + pos_g[:-1],
                                   state.neg_grad + neg_g[:-1],
                                   state.acc_loss + imp_loss[:-1].detach())
        return self.loss_weight * imp_loss.sum(), new_state


@LOSSES.register_module()
class EqualizedFocalLossV1:
    """EFL with its statistics over every channel, the objectness one
    (last) included."""

    def __init__(self, use_sigmoid=True, num_classes=1203, focal_gamma=2.0,
                 focal_alpha=0.25, scale_factor=8.0, reduction="mean",
                 loss_weight=1.0, test_with_obj=True, **kw):
        self.num_classes = num_classes
        self.focal_gamma = focal_gamma
        self.focal_alpha = focal_alpha
        self.scale_factor = scale_factor
        self.loss_weight = loss_weight
        self.test_with_obj = test_with_obj

    def get_channel_num(self, num_classes):
        return num_classes + 1

    def init_state(self, device=None) -> EFLState:
        c = self.num_classes + 1
        return EFLState(torch.zeros(c, device=device),
                        torch.zeros(c, device=device),
                        torch.ones(c, device=device))

    get_activation = EQLv2.get_activation

    def __call__(self, cls_score, label, state: EFLState, weight=None,
                 avg_factor=None):
        target = _one_hot(label, cls_score.shape[1], cls_score.dtype)
        loss = _focal(cls_score, target, state.pos_neg, self.focal_gamma,
                      self.focal_alpha, self.scale_factor)
        pos_g, neg_g = _gradient_sums(cls_score, target)
        pos_grad = state.pos_grad + pos_g
        neg_grad = state.neg_grad + neg_g
        pos_neg = (pos_grad / (neg_grad + 1e-10)).clamp(0, 1)
        return self.loss_weight * loss, EFLState(pos_grad, neg_grad, pos_neg)
