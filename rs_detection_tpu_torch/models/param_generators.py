"""Parameter-group generators (counterpart of the ``NormalPrameter...`` and
``YangXuePrameterGroupsGenerator`` of
``rs_detection_tpu/models/param_generators.py``; the reference spelling
is kept, since the configs name them so).

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
raises."""

from __future__ import annotations

import re

from ..utils.registry import MODELS, register_unported


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


# YOLO's decay masks come with its family (ROADMAP.md, Queue 1, item 11f)
register_unported(MODELS, ("YoloParameterGroupsGenerator",),
                  "the parameter-group generator", "11f")

