"""mmdet-style config sections onto the port's constructors (counterpart
of ``normalize_cfg`` in ``rs_detection_tpu/models/networks/compat.py``).

The configs carry keys of several generations of schema: loss sections
(``loss_bbox=dict(beta=..., loss_weight=...)``), a ``test_cfg`` and keys
no constructor takes (``end_bbox_type``, ``reg_decoded_bbox``, ...).
``normalize_cfg`` folds the first two onto the target class's own
arguments and drops the rest, exactly as the JAX package does against
its dataclass fields. The port has no dataclasses: a class's config
fields are the arguments of its ``__init__``.

The mmdet-v1 composed schema of ``projects/roi_transformer`` and
``projects/faster_rcnn`` (``rpn_head`` + ``bbox_roi_extractor`` +
``bbox_head`` + ``rbbox_*`` + ``train_cfg`` / ``test_cfg``) folds onto
``RPNHead`` and ``RoITransformerHead`` through ``adapt_rpn_cfg`` and
``adapt_cascade_head``, as in the JAX package: mmdet-v1 ``num_classes``
counts the background, flat ``anchor_*`` keys become the
``anchor_generator`` dict, per-stage ``target_stds`` become
``stage1_stds`` / ``stage2_stds``. Only a KFIoU stage-2 loss is mapped;
a GWD or KLD section is dropped and the stage trains smooth L1, as in
JAX.

A single-stage head section (``SingleStageDetector``'s ``bbox_head``,
``roi_heads`` or ``rpn_net``) goes through ``adapt_single_stage_head``:
the creator-style ``RetinaHead`` of ``projects/retinanet`` (``n_class``,
``mode``, an explicit rotated anchor generator) through
``adapt_legacy_retina``, R3Det's mmdet-v2 ``RRetinaHead`` through
``adapt_retina_like``, as in JAX; any other section through the
generic flattening of ``normalize_cfg``, which is what S2ANet's, FCOS's
and the modern ``RetinaHead`` take. R3Det's ``RRetinaRefineHead``
sections fold through ``adapt_refine_head``, SSD's ``SSDHead`` through
``adapt_ssd``. The legacy RetinaHead's ``loc_loss_weight`` and
``cls_loss_weight`` are dropped, as in JAX. As in JAX, S2ANet's ``loss_*`` sections reach the head only as
``focal_gamma`` / ``focal_alpha`` / ``smooth_l1_beta`` (the ODM section's
values, the later ones, override the FAM's; ``loss_weight`` is dropped),
``test_cfg`` as ``nms_pre`` / ``score_thr`` / ``max_per_img`` /
``nms_iou_thr``, and ``train_cfg`` as the FAM assigner's three IoU
thresholds; the ODM's own assigner section, ``pos_weight`` and
``allowed_border`` are dropped.
"""

from __future__ import annotations

import inspect
from collections.abc import Mapping
from typing import Any, Dict, Tuple

import numpy as np


def _plain(node):
    if isinstance(node, Mapping):
        return {k: _plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_plain(v) for v in node]
    return node


def adapt_rpn_cfg(cfg):
    """A legacy ``rpn_head`` section (``FasterrcnnHead`` / ``RPNHead`` with
    flat anchor keys) as an ``RPNHead`` section; any other passes
    through."""
    if cfg is None or not isinstance(cfg, Mapping):
        return cfg
    cfg = _plain(cfg)
    legacy = ("anchor_scales" in cfg or "loss_cls" in cfg
              or cfg.get("type") == "FasterrcnnHead")
    if not legacy:
        return cfg
    out = dict(type="RPNHead", in_channels=cfg.get("in_channels", 256),
               feat_channels=cfg.get("feat_channels", 256))
    if "anchor_scales" in cfg:
        out["anchor_generator"] = dict(
            scales=cfg["anchor_scales"],
            ratios=cfg.get("anchor_ratios", [0.5, 1.0, 2.0]),
            strides=cfg.get("anchor_strides", [4, 8, 16, 32, 64]))
    elif "anchor_generator" in cfg:
        out["anchor_generator"] = {k: v for k, v in
                                   cfg["anchor_generator"].items()
                                   if k != "type"}
    if "target_means" in cfg:
        out["target_means"] = list(cfg["target_means"])[:4]
    if "target_stds" in cfg:
        out["target_stds"] = list(cfg["target_stds"])[:4]
    lb = cfg.get("loss_bbox") or {}
    if "beta" in lb:
        out["smooth_l1_beta"] = lb["beta"]
    return out


def adapt_cascade_head(bbox_head, rbbox_head=None, bbox_roi_extractor=None,
                       rbbox_roi_extractor=None, train_cfg=None):
    """The mmdet-v1 cascade sections as one ``RoITransformerHead``
    section: two stages with ``rbbox_head``, FasterRCNN-OBB's one
    without it."""
    bbox_head = _plain(bbox_head) or {}
    rbbox_head = _plain(rbbox_head)
    stage2 = rbbox_head if rbbox_head is not None else bbox_head
    out = dict(type="RoITransformerHead",
               num_classes=int(stage2.get("num_classes", 16)) - 1,
               in_channels=bbox_head.get("in_channels", 256),
               num_stages=2 if rbbox_head is not None else 1)
    if "KFIoU" in str(stage2.get("type", "")) \
            or (stage2.get("loss_bbox") or {}).get("loss_type") == "kfiou":
        out["reg_loss"] = "kfiou"
    if bbox_head.get("target_stds") is not None:
        out["stage1_stds"] = list(bbox_head["target_stds"])
    if stage2.get("target_stds") is not None:
        out["stage2_stds"] = list(stage2["target_stds"])
    ext = _plain(bbox_roi_extractor) or _plain(rbbox_roi_extractor)
    if ext and ext.get("featmap_strides") is not None:
        out["featmap_strides"] = list(ext["featmap_strides"])
    rcnn = (_plain(train_cfg) or {}).get("rcnn")
    if isinstance(rcnn, list) and rcnn:
        rcnn = rcnn[0]
    if isinstance(rcnn, Mapping):
        smp = rcnn.get("sampler") or {}
        if "num" in smp:
            out["sampler_num"] = smp["num"]
        if "pos_fraction" in smp:
            out["pos_fraction"] = smp["pos_fraction"]
    return out


def adapt_single_stage_head(cfg):
    """A single-stage head section onto the port's head: the legacy
    creator-style ``RetinaHead`` through ``adapt_legacy_retina``,
    ``RRetinaHead`` through ``adapt_retina_like``, ``SSDHead`` through
    ``adapt_ssd``, any other section is flattened by
    ``normalize_cfg`` against its registered class."""
    if cfg is None or not isinstance(cfg, Mapping):
        return cfg
    cfg = _plain(cfg)
    t = cfg.get("type")
    if t == "SSDHead":
        return adapt_ssd(cfg)
    if t == "RRetinaHead":
        return adapt_retina_like(cfg)
    if t == "RetinaHead" and ("n_class" in cfg or "mode" in cfg):
        return adapt_legacy_retina(cfg)
    from ...utils.registry import HEADS

    return normalize_cfg(cfg, HEADS)


def adapt_ssd(cfg):
    """The zoo's mmdet ``SSDHead`` section as an ``SSDHead`` section, as
    the JAX ``_adapt_ssd`` folds it: ``num_classes`` plus the background,
    the anchor generator's strides, ratios, ``basesize_ratio_range`` and
    ``input_size``, the coder's means and stds (``bbox_coder_cfg`` or
    ``bbox_coder``), ``train_cfg``'s ``neg_pos_ratio`` and ``test_cfg``'s
    ``nms_pre``, ``score_thr``, ``max_per_img`` and the NMS IoU. The rest
    of ``train_cfg`` (the assigner, ``smoothl1_beta``, ``pos_weight``) is
    dropped: the head's assigner is fixed, as in JAX."""
    out = dict(cfg)
    out["num_classes"] = int(cfg.get("num_classes", 80)) + 1
    ag = out.pop("anchor_generator", None) or {}
    if ag.get("strides") is not None:
        out["anchor_strides"] = list(ag["strides"])
    if ag.get("ratios") is not None:
        out["anchor_ratios"] = [list(r) for r in ag["ratios"]]
    if ag.get("basesize_ratio_range") is not None:
        out["basesize_ratio_range"] = tuple(ag["basesize_ratio_range"])
    if ag.get("input_size") is not None:
        out["input_size"] = int(ag["input_size"])
    coder = out.pop("bbox_coder_cfg", None) or out.pop("bbox_coder",
                                                       None) or {}
    if coder.get("target_means") is not None:
        out["target_means"] = list(coder["target_means"])
    if coder.get("target_stds") is not None:
        out["target_stds"] = list(coder["target_stds"])
    tc = out.pop("train_cfg", None) or {}
    if "neg_pos_ratio" in tc:
        out["neg_pos_ratio"] = tc["neg_pos_ratio"]
    ec = out.pop("test_cfg", None) or {}
    for k in ("nms_pre", "score_thr", "max_per_img"):
        if k in ec:
            out[k] = ec[k]
    nms = ec.get("nms") or {}
    if "iou_threshold" in nms:
        out["nms_iou_thr"] = nms["iou_threshold"]
    from ..roi_heads.ssd_head import SSDHead

    return _filter_to_fields(SSDHead, out)


def adapt_legacy_retina(cfg):
    """The creator-style ``RetinaHead`` section (``n_class``, ``mode``,
    an explicit rotated anchor generator) as a ``RetinaHead`` section,
    as the JAX ``_adapt_legacy_retina`` folds it: ``n_class`` plus the
    background, ``score_threshold`` / ``nms_iou_threshold`` / ``roi_beta``
    to their fields, ``max_dets`` capped at 4096 slots, the octave base
    scale and the scales per octave recovered from ``base_sizes``,
    ``strides`` and ``scales``, the angles in radians where they are
    written in degrees. Everything else (``loc_loss_weight``,
    ``cls_loss_weight``, the generator's ``type`` and ``mode``) is
    dropped."""
    out = dict(type="RetinaHead",
               num_classes=int(cfg.get("n_class", 15)) + 1,
               in_channels=cfg.get("in_channels", 256),
               feat_channels=cfg.get("feat_channels",
                                     cfg.get("in_channels", 256)),
               stacked_convs=cfg.get("stacked_convs", 4))
    if "score_threshold" in cfg:
        out["score_thr"] = cfg["score_threshold"]
    if "nms_iou_threshold" in cfg:
        out["nms_iou_thr"] = cfg["nms_iou_threshold"]
    if "max_dets" in cfg:
        out["max_per_img"] = min(int(cfg["max_dets"]), 4096)
    if "roi_beta" in cfg:
        out["smooth_l1_beta"] = cfg["roi_beta"]
    ag = cfg.get("anchor_generator") or {}
    if ag.get("strides") is not None:
        out["anchor_strides"] = list(ag["strides"])
    if ag.get("ratios") is not None:
        out["anchor_ratios"] = list(ag["ratios"])
    scales, base_sizes = ag.get("scales"), ag.get("base_sizes")
    if scales is not None and base_sizes is not None \
            and ag.get("strides") is not None:
        out["octave_base_scale"] = int(round(
            base_sizes[0] / ag["strides"][0] * scales[0]))
        out["scales_per_octave"] = len(scales)
    angles = ag.get("angles")
    if angles:
        arr = np.asarray(angles, np.float64)
        if np.abs(arr).max() > 3.2:          # degrees -> radians
            arr = arr * np.pi / 180.0
        out["anchor_angles"] = [float(a) for a in arr]
    from ..roi_heads.retina_head import RetinaHead

    return _filter_to_fields(RetinaHead, out)


def adapt_retina_like(cfg):
    """R3Det's mmdet-v2 ``RRetinaHead`` section as a ``RetinaHead``
    section, as the JAX ``adapt_retina_like`` folds it: ``num_classes``
    plus the background, the anchor generator's octave base scale, scales
    per octave, ratios, strides and angles (None keeps the head's 0), the
    coder's means and stds, the focal gamma / alpha and the smooth-L1
    beta. Everything else (``use_h_gt``, the losses' weights) is
    dropped."""
    cfg = _plain(cfg)
    out = dict(type="RetinaHead",
               num_classes=int(cfg.get("num_classes", 15)) + 1,
               in_channels=cfg.get("in_channels", 256),
               feat_channels=cfg.get("feat_channels", 256),
               stacked_convs=cfg.get("stacked_convs", 4))
    ag = cfg.get("anchor_generator") or {}
    for src, dst in (("octave_base_scale", "octave_base_scale"),
                     ("scales_per_octave", "scales_per_octave")):
        if src in ag:
            out[dst] = ag[src]
    if ag.get("ratios") is not None:
        out["anchor_ratios"] = list(ag["ratios"])
    if ag.get("strides") is not None:
        out["anchor_strides"] = list(ag["strides"])
    if ag.get("angles"):
        out["anchor_angles"] = list(ag["angles"])
    coder = cfg.get("bbox_coder") or {}
    if coder.get("target_means") is not None:
        out["target_means"] = list(coder["target_means"])
    if coder.get("target_stds") is not None:
        out["target_stds"] = list(coder["target_stds"])
    lc = cfg.get("loss_cls") or {}
    if "gamma" in lc:
        out["focal_gamma"] = lc["gamma"]
    if "alpha" in lc:
        out["focal_alpha"] = lc["alpha"]
    lb = cfg.get("loss_bbox") or {}
    if "beta" in lb:
        out["smooth_l1_beta"] = lb["beta"]
    return out


def adapt_refine_head(cfg, num_classes_fallback=16):
    """R3Det's ``RRetinaRefineHead`` section as an ``R3DetRefineHead``
    section, as in JAX: ``num_classes`` plus the background, the widths,
    ``stacked_convs`` and the coder's stds; the pseudo anchor generator,
    the coder's means and the losses are dropped."""
    cfg = _plain(cfg)
    out = dict(type="R3DetRefineHead",
               num_classes=int(cfg.get("num_classes",
                                       num_classes_fallback - 1)) + 1,
               in_channels=cfg.get("in_channels", 256),
               feat_channels=cfg.get("feat_channels", 256),
               stacked_convs=cfg.get("stacked_convs", 2))
    coder = cfg.get("bbox_coder") or {}
    if coder.get("target_stds") is not None:
        out["target_stds"] = list(coder["target_stds"])
    return out


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
