"""mmdet-style config sections onto the port's constructors (counterpart
of ``normalize_cfg`` in ``rs_detection_tpu/models/networks/compat.py``).

The configs carry keys of several generations of schema: loss sections
(``loss_bbox=dict(beta=..., loss_weight=...)``), a ``test_cfg`` and keys
no constructor takes (``end_bbox_type``, ``reg_decoded_bbox``, ...).
``normalize_cfg`` folds the first two onto the target class's own
arguments and drops the rest, exactly as the JAX package does against
its dataclass fields. The port has no dataclasses: a class's config
fields are the arguments of its ``__init__``.
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping
from typing import Any, Dict, Tuple


def _plain(node):
    if isinstance(node, Mapping):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def config_fields(cls) -> Tuple[str, ...]:
    """The keyword arguments a config may set on ``cls``."""
    params = inspect.signature(cls).parameters.values()
    return tuple(p.name for p in params
                 if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY))


def section_kwargs(cfg, default) -> Dict[str, Any]:
    """A sub-config (``assigner=dict(type=..., ...)``) as constructor
    kwargs: ``default`` when None, the ``type`` key and an assigner's
    ``assigned_labels_filled`` dropped, as the JAX heads do."""
    out = {k: v for k, v in dict(cfg or default).items() if k != "type"}
    out.pop("assigned_labels_filled", None)
    return out


def _filter_to_fields(cls, kw: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only the keys ``cls`` declares (plus 'type')."""
    names = set(config_fields(cls))
    return {k: v for k, v in kw.items() if k in names or k == "type"}


def normalize_cfg(cfg, registry) -> Dict[str, Any]:
    """Flatten an mmdet-style section against its target class:
    ``loss_*_cls`` gamma/alpha -> ``focal_gamma``/``focal_alpha`` (and
    ``loss_weight`` -> ``loss_cls_weight``), ``loss_*_bbox`` beta /
    loss_weight -> ``smooth_l1_beta`` / ``loss_bbox_weight``,
    ``test_cfg`` keys -> same-named fields (+ nms iou thresholds ->
    ``nms_iou_thr``), ``train_cfg`` assigner thresholds -> pos/neg/min
    iou fields; then drop anything the class does not declare. Each
    mapping applies only where the class declares the target field.
    Constructor functions (``van_b3``, ...) and unknown types pass
    through untouched, as in the JAX package."""
    if cfg is None or not isinstance(cfg, Mapping):
        return cfg
    t = cfg.get("type")
    try:
        cls = registry.get(t) if t else None
    except KeyError:
        return cfg
    if cls is None or not inspect.isclass(cls):
        return cfg
    names = set(config_fields(cls))
    out = dict(_plain(cfg))
    for key in list(out):
        sec = out[key]
        if not isinstance(sec, Mapping) or key in names:
            continue
        if key.startswith("loss") and key.endswith("cls"):
            if "gamma" in sec and "focal_gamma" in names:
                out["focal_gamma"] = sec["gamma"]
            if "alpha" in sec and "focal_alpha" in names:
                out["focal_alpha"] = sec["alpha"]
            if "loss_weight" in sec and "loss_cls_weight" in names:
                out["loss_cls_weight"] = sec["loss_weight"]
        elif key.startswith("loss") and key.endswith("bbox"):
            if "beta" in sec and "smooth_l1_beta" in names:
                out["smooth_l1_beta"] = sec["beta"]
            if "loss_weight" in sec and "loss_bbox_weight" in names:
                out["loss_bbox_weight"] = sec["loss_weight"]
        elif key == "test_cfg":
            for k, v in sec.items():
                if not isinstance(v, Mapping) and k in names:
                    out.setdefault(k, v)
            nms = sec.get("nms") or {}
            thr = nms.get("iou_thr", nms.get("iou_threshold"))
            if thr is not None and "nms_iou_thr" in names:
                out["nms_iou_thr"] = thr
        elif key == "train_cfg":
            asn = sec.get("assigner") or \
                (sec.get("fam_cfg") or {}).get("assigner") or {}
            for k in ("pos_iou_thr", "neg_iou_thr", "min_pos_iou"):
                if k in asn and k in names:
                    out[k] = asn[k]
    return _filter_to_fields(cls, out)
