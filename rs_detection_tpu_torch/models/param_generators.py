"""Parameter-group generators (counterpart of the ``NormalPrameter...``,
``YangXuePrameterGroupsGenerator`` and ``YoloParameterGroupsGenerator``
of ``rs_detection_tpu/models/param_generators.py``; the reference
spelling is kept, since the configs name them so).

A generator is built from the config's ``parameter_groups_generator``
section and returns ``wrap(optimizer, base_weight_decay)``, which links
its masked transforms into one of ``optims/optimizer.py``'s optimizers
and returns it, as the JAX ``wrap(tx, base_weight_decay)`` chains optax
links around ``tx``. The JAX chain of the retinanet recipe is
``[conv-bias grads x m] -> [conv-bias decay correction] -> (clip ->
multipliers -> decay -> sgd) -> [freeze to zero]``, so the scaled
conv-bias gradients and the correction enter the global-norm clip; the
port's ``grad_links`` run before the clip for the same reason, and the
frozen parameters keep their values through the step.

A conv bias is a ``bias`` beside a 4-D ``weight`` (a ``Conv2d``'s; not a
``Linear``'s or a norm's), as the JAX mask reads a ``bias`` beside a 4-D
``kernel``. ``freeze_prefix`` entries are dotted name prefixes;
``backbone.C1`` is the ResNet stem and ``backbone.C<k>`` its stage k - 1,
as in the reference recipe. A prefix list that matches no parameter
raises.

``YoloParameterGroupsGenerator`` is the JAX class: called on the
parameters it returns the decay mask (``weight_decay_mask``) and its
``weight_decay``. It takes no ``base_weight_decay``, so the runner
builds it and applies none of it, as the JAX runner does
(``takes_base_weight_decay``): the COCO YOLO recipes train without
weight decay, and ``yolov5s_dota.py`` with its SGD's decay on every
parameter."""

from __future__ import annotations

import inspect
import re

from ..utils.registry import MODELS


def conv_bias_params(named):
    """The parameters of ``named`` ((name, parameter) pairs) that are a
    conv's bias: ``x.bias`` where ``x.weight`` is 4-D."""
    shapes = {n: p.ndim for n, p in named}
    return [p for n, p in named if n.endswith(".bias")
            and shapes.get(n[:-len("bias")] + "weight") == 4]


def expand_prefix(pref: str):
    """A reference-style ResNet stage name in the port's names:
    ``backbone.C1`` is the stem (``Conv_k`` / ``Norm_k`` at the
    backbone's top), ``backbone.C<k>`` the ``layer<k-1>_*`` blocks; any
    other prefix stands as it is."""
    head, _, tail = pref.rpartition(".")
    m = re.fullmatch(r"C([1-5])", tail)
    if not m:
        return [pref]
    base = head + "." if head else ""
    k = int(m.group(1))
    if k == 1:
        return [base + "Conv_", base + "Norm_"]
    return [base + f"layer{k - 1}_", base + f"layer{k - 1}."]


def prefix_params(named, prefixes):
    """The parameters whose name starts with one of ``prefixes`` (each
    expanded by ``expand_prefix``). Raises when ``prefixes`` match
    nothing: a freeze that matches nothing trains what it meant to
    freeze."""
    expanded = tuple(q for p in prefixes
                     for q in expand_prefix(str(p).replace("/", ".")))
    out = [p for n, p in named if any(n.startswith(q) for q in expanded)]
    if prefixes and not out:
        tops = sorted({n.split(".")[0] for n, _ in named})[:20]
        raise ValueError(f"parameter-group prefixes {tuple(prefixes)} "
                         f"(expanded to {expanded}) matched NO parameters; "
                         f"top-level names: {tops}")
    return out


@MODELS.register_module()
def NormalPrameterGroupsGenerator(**kw):
    """Identity grouping (reference ``projects/retinanet/models.py:6-11``)."""

    def wrap(optimizer, base_weight_decay=0.0):
        return optimizer

    return wrap


@MODELS.register_module()
def YangXuePrameterGroupsGenerator(conv_bias_grad_muyilpy: float = 1.0,
                                   conv_bias_weight_decay: float = -1,
                                   freeze_prefix=(), **kw):
    """The reference retinanet recipe's grouping
    (``projects/retinanet/models.py:14-65``): the conv biases' gradients
    times ``conv_bias_grad_muyilpy``; with ``conv_bias_weight_decay`` >= 0
    (and a base decay) their decay corrected from the optimizer's to that
    value by adding ``(conv_bias_weight_decay - base) * p`` to their
    gradients; the ``freeze_prefix`` parameters not moved at all."""

    def wrap(optimizer, base_weight_decay: float = 0.0):
        named = optimizer.named_params()
        biases = conv_bias_params(named)
        if conv_bias_grad_muyilpy != 1.0:
            def scale(ps=biases, m=float(conv_bias_grad_muyilpy)):
                for p in ps:
                    p.grad.mul_(m)
            optimizer.grad_links.append(scale)
        if conv_bias_weight_decay >= 0 and base_weight_decay:
            def decay(ps=biases, wd=float(conv_bias_weight_decay
                                          - base_weight_decay)):
                for p in ps:
                    p.grad.add_(p.detach(), alpha=wd)
            optimizer.grad_links.append(decay)
        if freeze_prefix:
            optimizer.frozen.extend(prefix_params(named, freeze_prefix))
        return optimizer

    return wrap


def weight_decay_mask(named):
    """{name: True where weight decay applies}: the conv and linear
    weights, not biases, norm scales or any other 1-D parameter (the
    JAX mask on the flax ``kernel`` / ``scale`` / ``bias`` names)."""
    return {n: not (n.endswith(".bias") or p.ndim <= 1) for n, p in named}


@MODELS.register_module()
class YoloParameterGroupsGenerator:
    """The reference's three YOLO groups as a decay mask: ``self(named)``
    gives ``dict(decay_mask=weight_decay_mask(named), weight_decay=...)``.
    ``batch_size`` and any other key are accepted and ignored."""

    def __init__(self, weight_decay: float = 0.0005, **kw):
        self.weight_decay = weight_decay

    def __call__(self, params):
        return dict(decay_mask=weight_decay_mask(params),
                    weight_decay=self.weight_decay)


def takes_base_weight_decay(gen) -> bool:
    """Whether the runner links ``gen`` into its optimizer: a callable
    with no ``decay_mask`` that takes ``base_weight_decay``, the JAX
    runner's signature check (``rs_detection_tpu/runner/runner.py:
    184-195``)."""
    if not callable(gen) or hasattr(gen, "decay_mask"):
        return False
    try:
        return "base_weight_decay" in inspect.signature(gen).parameters
    except (TypeError, ValueError):
        return False

