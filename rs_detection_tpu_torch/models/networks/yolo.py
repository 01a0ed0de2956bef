"""YOLOv5, horizontal boxes (counterpart of
``rs_detection_tpu/models/networks/yolo.py``): the ``CSPDarknet``
backbone (6x6 stride-2 stem, C3 stages, SPPF), the ``YOLOPAN`` neck, the
anchor-based ``YOLOv5Head`` at strides 8 / 16 / 32 and ``YOLO`` with its
``YOLOv5S`` / ``M`` / ``L`` / ``X`` variants.

Every conv of the body is ``add_conv`` / ``run_conv``, the JAX
``_conv``: a bias-free conv with padding
(k - 1) // 2, BatchNorm with eps 1e-3 and SiLU. As in JAX, where
``_conv`` builds ``nn.BatchNorm(use_running_average=True)``, the norm
normalizes with its running statistics in every mode and never moves
them: a training step treats it as a fixed affine map. The layers carry
the flax names (``stem_conv`` / ``stem_bn``, ``c3_1.m0.cv1_conv``,
``sppf``, ``lat5``, ``td4``, ``bu6``, the head's ``out{i}``). The
modules take and give NHWC tensors; the convs run on the NCHW view (a
channels-last tensor on the card).

``YOLOv5Head.loss`` builds dense targets as the JAX head does: per level
the anchors that pass the wh-ratio test at ``anchor_t``, at the gt's
cell under each of five offsets (with JAX's ``near`` masks, floor
``%``), gathered at the clipped cell; CIoU with ``alpha`` detached, the
class BCE as the mean over classes, the objectness target as the
scatter-max of the detached IoU, the levels' ``balance``, ``n_pos`` from
1e-7, the gains times the batch size. ``get_bboxes`` takes the 1000
best candidates a level by their best ``sigmoid(obj) * sigmoid(cls)``,
the ``conf_thr`` threshold, a class-aware greedy NMS at ``nms_iou`` and
the ``max_det`` best; its labels are 0-based (-1 for an empty slot),
where JAX's are 1-based, as every other single-stage head of the port.
The JAX path reaches no Pallas kernel, and neither does this one."""

from __future__ import annotations

import math
from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops import box_ops as B
from ...ops.nms import bbox_overlaps_hbb, greedy_suppress_mask, top_k
from ...utils.registry import BACKBONES, HEADS, MODELS, NECKS
from ..losses.common import sigmoid_bce
from ..utils.modules import conv2d
from .rcnn import _build
from .single_stage import SingleStageDetector

# default COCO anchors per level (stride 8 / 16 / 32), (w, h) pairs
YOLO_ANCHORS = (
    ((10, 13), (16, 30), (33, 23)),
    ((30, 61), (62, 45), (59, 119)),
    ((116, 90), (156, 198), (373, 326)),
)
OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))


class RunningBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm that normalizes with its running statistics in every
    mode and never updates them (flax ``use_running_average=True``)."""

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


def add_conv(parent: nn.Module, name: str, cin: int, cout: int, k: int = 1,
             s: int = 1) -> None:
    """Give ``parent`` the layers of the JAX ``_conv(x, cout, k, s, name)``
    under its flax names: ``{name}_conv`` (bias-free, padding (k - 1) //
    2) and ``{name}_bn`` (``RunningBatchNorm2d``, eps 1e-3, torch
    momentum 0.03 = flax 0.97); ``run_conv`` applies them with SiLU."""
    parent.add_module(f"{name}_conv", nn.Conv2d(cin, cout, k, s,
                                                (k - 1) // 2, bias=False))
    parent.add_module(f"{name}_bn", RunningBatchNorm2d(cout, eps=1e-3,
                                                       momentum=0.03))


def run_conv(parent: nn.Module, name: str, x):
    """SiLU(bn(conv(x))) of the layers ``add_conv`` gave ``parent``."""
    return F.silu(getattr(parent, f"{name}_bn")(
        conv2d(getattr(parent, f"{name}_conv"), x)))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, c: int, shortcut: bool = True):
        super().__init__()
        add_conv(self, "cv1", cin, c, 1)
        add_conv(self, "cv2", c, c, 3)
        self.add = shortcut and cin == c

    def forward(self, x):
        y = run_conv(self, "cv2", run_conv(self, "cv1", x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, cin: int, c: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c_ = c // 2
        add_conv(self, "cv1", cin, c_, 1)
        self.n = n
        for i in range(n):
            self.add_module(f"m{i}", Bottleneck(c_, c_, shortcut))
        add_conv(self, "cv2", cin, c_, 1)
        add_conv(self, "cv3", 2 * c_, c, 1)

    def forward(self, x):
        y1 = run_conv(self, "cv1", x)
        for i in range(self.n):
            y1 = getattr(self, f"m{i}")(y1)
        y2 = run_conv(self, "cv2", x)
        return run_conv(self, "cv3", torch.cat([y1, y2], 1))


class SPPF(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        c_ = cin // 2
        add_conv(self, "cv1", cin, c_, 1)
        add_conv(self, "cv2", 4 * c_, c, 1)

    def forward(self, x):
        y = run_conv(self, "cv1", x)
        p1 = F.max_pool2d(y, 5, 1, 2)
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return run_conv(self, "cv2", torch.cat([y, p1, p2, p3], 1))


class _Multiples:
    """The width and depth rounding of the JAX ``_w`` / ``_d``."""

    def _w(self, c):
        return max(int(round(c * self.width_multiple / 8)) * 8, 8)

    def _d(self, n):
        return max(int(round(n * self.depth_multiple)), 1)


def _up(x):
    """Nearest x2 (``jnp.repeat`` on both spatial axes)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


@BACKBONES.register_module()
class CSPDarknet(_Multiples, nn.Module):
    """Returns (p3, p4, p5) at strides 8 / 16 / 32, widths ``out_channels``."""

    def __init__(self, depth_multiple: float = 0.33,
                 width_multiple: float = 0.5):
        nn.Module.__init__(self)
        self.depth_multiple = depth_multiple
        self.width_multiple = width_multiple
        w, d = self._w, self._d
        add_conv(self, "stem", 3, w(64), 6, 2)
        add_conv(self, "down1", w(64), w(128), 3, 2)
        self.c3_1 = C3(w(128), w(128), d(3))
        add_conv(self, "down2", w(128), w(256), 3, 2)
        self.c3_2 = C3(w(256), w(256), d(6))
        add_conv(self, "down3", w(256), w(512), 3, 2)
        self.c3_3 = C3(w(512), w(512), d(9))
        add_conv(self, "down4", w(512), w(1024), 3, 2)
        self.c3_4 = C3(w(1024), w(1024), d(3))
        self.sppf = SPPF(w(1024), w(1024))
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, images, train: bool = False):
        """images NHWC -> three NHWC levels; ``train`` changes nothing."""
        x = images.permute(0, 3, 1, 2)
        x = run_conv(self, "stem", x)
        x = self.c3_1(run_conv(self, "down1", x))
        x = p3 = self.c3_2(run_conv(self, "down2", x))
        x = p4 = self.c3_3(run_conv(self, "down3", x))
        x = self.c3_4(run_conv(self, "down4", x))
        p5 = self.sppf(x)
        return tuple(f.permute(0, 2, 3, 1) for f in (p3, p4, p5))


@NECKS.register_module()
class YOLOPAN(_Multiples, nn.Module):
    """The JAX neck: top-down (``lat5``, ``td4``, ``lat4``, ``td3``) then
    bottom-up (``bu3``, ``bu4``, ``bu5``, ``bu6``); the concatenations in
    JAX's order. ``in_channels`` are the backbone's widths (flax infers
    them; by default those of a ``CSPDarknet`` at the same multiples)."""

    def __init__(self, depth_multiple: float = 0.33,
                 width_multiple: float = 0.5,
                 in_channels: Sequence[int] = None):
        nn.Module.__init__(self)
        self.depth_multiple = depth_multiple
        self.width_multiple = width_multiple
        w, d = self._w, self._d
        c3, c4, c5 = in_channels or (w(256), w(512), w(1024))
        add_conv(self, "lat5", c5, w(512), 1)
        self.td4 = C3(w(512) + c4, w(512), d(3), shortcut=False)
        add_conv(self, "lat4", w(512), w(256), 1)
        self.td3 = C3(w(256) + c3, w(256), d(3), shortcut=False)
        add_conv(self, "bu3", w(256), w(256), 3, 2)
        self.bu4 = C3(2 * w(256), w(512), d(3), shortcut=False)
        add_conv(self, "bu5", w(512), w(512), 3, 2)
        self.bu6 = C3(2 * w(512), w(1024), d(3), shortcut=False)
        self.out_channels = (w(256), w(512), w(1024))

    def forward(self, feats, train: bool = False):
        p3, p4, p5 = (f.permute(0, 3, 1, 2) for f in feats)
        x = run_conv(self, "lat5", p5)
        f4 = self.td4(torch.cat([_up(x), p4], 1))
        y = run_conv(self, "lat4", f4)
        out3 = self.td3(torch.cat([_up(y), p3], 1))
        z = run_conv(self, "bu3", out3)
        out4 = self.bu4(torch.cat([z, y], 1))
        z = run_conv(self, "bu5", out4)
        out5 = self.bu6(torch.cat([z, x], 1))
        return tuple(f.permute(0, 2, 3, 1) for f in (out3, out4, out5))


def ciou(px, py, pw, ph, gx, gy, gw, gh, eps=1e-7):
    """Complete IoU of center-size boxes, ``alpha`` detached (the JAX
    ``_ciou``)."""
    px1, px2 = px - pw / 2, px + pw / 2
    py1, py2 = py - ph / 2, py + ph / 2
    gx1, gx2 = gx - gw / 2, gx + gw / 2
    gy1, gy2 = gy - gh / 2, gy + gh / 2
    iw = (torch.minimum(px2, gx2) - torch.maximum(px1, gx1)).clamp(min=0)
    ih = (torch.minimum(py2, gy2) - torch.maximum(py1, gy1)).clamp(min=0)
    inter = iw * ih
    iou = inter / (pw * ph + gw * gh - inter + eps)
    cw = torch.maximum(px2, gx2) - torch.minimum(px1, gx1)
    ch = torch.maximum(py2, gy2) - torch.minimum(py1, gy1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (gx - px) ** 2 + (gy - py) ** 2
    v = (4 / math.pi ** 2) * (torch.atan(gw / (gh + eps))
                              - torch.atan(pw / (ph + eps))) ** 2
    alpha = (v / (v - iou + 1 + eps)).detach()
    return iou - rho2 / c2 - v * alpha


@HEADS.register_module()
class YOLOv5Head(nn.Module):
    """The JAX head's fields with its defaults; ``in_channels`` are the
    neck's widths (flax infers them; ``YOLO`` passes its neck's)."""

    def __init__(self, num_classes: int = 80,
                 strides: Sequence[int] = (8, 16, 32),
                 anchors: Any = YOLO_ANCHORS, box_w: float = 0.05,
                 obj_w: float = 1.0, cls_w: float = 0.5,
                 anchor_t: float = 4.0,
                 balance: Sequence[float] = (4.0, 1.0, 0.4),
                 conf_thr: float = 0.25, nms_iou: float = 0.45,
                 max_det: int = 300,
                 in_channels: Sequence[int] = (128, 256, 512)):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.anchors = tuple(tuple(tuple(float(v) for v in a) for a in lvl)
                             for lvl in anchors)
        self.na = len(self.anchors[0])
        self.box_w, self.obj_w, self.cls_w = box_w, obj_w, cls_w
        self.anchor_t = anchor_t
        self.balance = tuple(balance)
        self.conf_thr, self.nms_iou, self.max_det = conf_thr, nms_iou, max_det
        for i, c in enumerate(in_channels):
            self.add_module(f"out{i}", nn.Conv2d(
                c, self.na * (5 + num_classes), 1))

    def init_weights(self, g: torch.Generator) -> None:
        """The flax default of the ``out{i}`` convs: LeCun normal
        (truncated at 2 std), zero bias."""
        with torch.no_grad():
            for i in range(len(self.strides)):
                conv = getattr(self, f"out{i}")
                std = math.sqrt(1.0 / conv.in_channels) / .87962566103423978
                nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std,
                                      2 * std, generator=g)
                nn.init.zeros_(conv.bias)

    def forward(self, feats, train: bool = False):
        """NHWC levels -> [B, H, W, A * (5 + C)] a level."""
        return [conv2d(getattr(self, f"out{i}"), f.permute(0, 3, 1, 2))
                .permute(0, 2, 3, 1) for i, f in enumerate(feats)]

    def _anchors(self, lvl, ref):
        return torch.tensor(self.anchors[lvl], dtype=torch.float32,
                            device=ref.device)

    def _decode_level(self, pred, lvl):
        """[B, H, W, A * (5 + C)] -> (centers [B, H, W, A, 2], wh [B, H,
        W, A, 2], obj logits [B, H, W, A], cls logits [B, H, W, A, C])."""
        b, h, wd, _ = pred.shape
        p = pred.reshape(b, h, wd, self.na, 5 + self.num_classes)
        xy = torch.sigmoid(p[..., :2]) * 2 - 0.5
        gx = torch.arange(wd, dtype=torch.float32,
                          device=p.device)[None, None, :, None]
        gy = torch.arange(h, dtype=torch.float32,
                          device=p.device)[None, :, None, None]
        stride = self.strides[lvl]
        cx = (xy[..., 0] + gx) * stride
        cy = (xy[..., 1] + gy) * stride
        wh = (torch.sigmoid(p[..., 2:4]) * 2) ** 2 * self._anchors(lvl, p)
        return torch.stack([cx, cy], -1), wh, p[..., 4], p[..., 5:]

    def loss(self, preds, targets):
        """``targets``: ``hboxes`` [B, G, 4], ``gt_mask`` [B, G],
        ``labels`` [B, G] (1-based). Returns box_loss, obj_loss,
        cls_loss."""
        gt = targets["hboxes"]
        gt_mask = targets["gt_mask"].bool()
        labels0 = (targets["labels"].long() - 1).clamp(min=0)
        gcx = (gt[..., 0] + gt[..., 2]) / 2
        gcy = (gt[..., 1] + gt[..., 3]) / 2
        gw = gt[..., 2] - gt[..., 0]
        gh = gt[..., 3] - gt[..., 1]
        bsz, g = gcx.shape
        onehot = F.one_hot(labels0, self.num_classes).to(preds[0].dtype)
        arange_a = torch.arange(self.na, device=gt.device)
        bi = torch.arange(bsz, device=gt.device)[:, None, None]
        total_box = total_obj = total_cls = 0.0
        for lvl, pred in enumerate(preds):
            stride = self.strides[lvl]
            b, h, wd, _ = pred.shape
            p = pred.reshape(b, h, wd, self.na, 5 + self.num_classes)
            anc = self._anchors(lvl, p)
            r = torch.stack([gw[..., None] / anc[:, 0],
                             gh[..., None] / anc[:, 1]], -1)
            ratio_ok = torch.maximum(r, 1 / r).amax(-1) < self.anchor_t
            cell_x, cell_y = gcx / stride, gcy / stride
            frac_x = torch.remainder(cell_x, 1)
            frac_y = torch.remainder(cell_y, 1)
            obj_t = torch.zeros(b, h, wd, self.na, dtype=p.dtype,
                                device=p.device)
            box_loss = cls_loss = 0.0
            n_pos = 1e-7
            for ox, oy in OFFSETS:
                cx_i = torch.floor(cell_x + ox * 0.5).long()
                cy_i = torch.floor(cell_y + oy * 0.5).long()
                if ox == 1:
                    near = frac_x < 0.5
                elif ox == -1:
                    near = frac_x > 0.5
                elif oy == 1:
                    near = frac_y < 0.5
                elif oy == -1:
                    near = frac_y > 0.5
                else:
                    near = torch.ones_like(gt_mask)
                ok = (gt_mask & near & (cx_i >= 0) & (cx_i < wd)
                      & (cy_i >= 0) & (cy_i < h))
                sel = ok[..., None] & ratio_ok                # [B, G, A]
                cyc = cy_i.clamp(0, h - 1)[..., None]
                cxc = cx_i.clamp(0, wd - 1)[..., None]
                pg = p[bi, cyc, cxc, arange_a]                # [B, G, A, 5+C]
                pxy = torch.sigmoid(pg[..., :2]) * 2 - 0.5
                pwh = (torch.sigmoid(pg[..., 2:4]) * 2) ** 2 * anc
                px = (pxy[..., 0] + cx_i[..., None]) * stride
                py = (pxy[..., 1] + cy_i[..., None]) * stride
                iou = ciou(px, py, pwh[..., 0], pwh[..., 1], gcx[..., None],
                           gcy[..., None], gw[..., None], gh[..., None])
                box_loss = box_loss + torch.where(sel, 1.0 - iou, 0.0).sum()
                cls_bce = sigmoid_bce(pg[..., 5:], onehot[:, :, None]).mean(-1)
                cls_loss = cls_loss + torch.where(sel, cls_bce, 0.0).sum()
                n_pos = n_pos + sel.sum().to(p.dtype)
                flat = ((bi * h + cyc) * wd + cxc) * self.na + arange_a
                obj_t = obj_t.view(-1).scatter_reduce(
                    0, flat.reshape(-1),
                    torch.where(sel, iou.detach(), 0.0).reshape(-1), "amax",
                    include_self=True).view(b, h, wd, self.na)
            obj_bce = sigmoid_bce(p[..., 4], obj_t)
            total_obj = total_obj + obj_bce.mean() * self.balance[lvl]
            total_box = total_box + box_loss / n_pos
            total_cls = total_cls + cls_loss / n_pos
        return dict(box_loss=total_box * self.box_w * bsz,
                    obj_loss=total_obj * self.obj_w * bsz,
                    cls_loss=total_cls * self.cls_w * bsz)

    def candidates(self, preds, i):
        """Image ``i``'s candidates: the 1000 best a level by their best
        class confidence -> (hbbs [K, 4], confidences [K, C])."""
        boxes, scores = [], []
        for lvl, pred in enumerate(preds):
            ctr, wh, obj, cls = self._decode_level(pred[i:i + 1], lvl)
            conf = (torch.sigmoid(obj)[..., None]
                    * torch.sigmoid(cls)).reshape(-1, self.num_classes)
            box = torch.cat([ctr - wh / 2, ctr + wh / 2], -1).reshape(-1, 4)
            _, idx = top_k(conf.amax(-1), min(1000, conf.shape[0]))
            boxes.append(box[idx])
            scores.append(conf[idx])
        return torch.cat(boxes), torch.cat(scores)

    def nms(self, boxes, scores):
        """Class-aware greedy NMS of one image's candidates -> (the
        ``max_det`` best kept (score, index) slots, -inf where empty,
        and every candidate's best class, 0-based)."""
        best = scores.amax(-1)
        lab = scores.argmax(-1)
        ok = best > self.conf_thr
        order = torch.sort(torch.where(ok, best, -torch.inf),
                           descending=True, stable=True).indices
        ob, ol = boxes[order], lab[order]
        over = torch.where(ol[:, None] == ol[None, :],
                           bbox_overlaps_hbb(ob, ob), 0.0) > self.nms_iou
        keep = torch.zeros_like(ok)
        keep[order] = greedy_suppress_mask(over, ok[order])
        out_s, sel = top_k(torch.where(keep, best, -torch.inf),
                           min(self.max_det, best.shape[0]))
        return out_s, sel, lab

    def get_bboxes(self, preds, scale_factor=None):
        """Detections of ``forward(feats)``: dict of polys [B, P, 8]
        (hbb corners), scores [B, P], labels [B, P] (0-based, -1 empty)
        and valid [B, P], by descending score. ``scale_factor`` is
        ignored, as in JAX."""
        results = []
        for i in range(preds[0].shape[0]):
            boxes, scores = self.candidates(preds, i)
            out_s, sel, lab = self.nms(boxes, scores)
            valid = torch.isfinite(out_s)
            results.append((B.hbb2poly(boxes[sel]),
                            torch.where(valid, out_s, 0.0),
                            torch.where(valid, lab[sel], -1), valid))
        return {key: torch.stack([r[j] for r in results])
                for j, key in enumerate(("polys", "scores", "labels",
                                         "valid"))}


@MODELS.register_module()
class YOLO(SingleStageDetector):
    """YOLOv5 in the reference schema
    (``projects/yolo/configs/yolo_model_base.py``: the flat loss gains,
    ``nc``, ``anchor_t`` and the multiples configure the default
    backbone, neck and head), or with ``backbone`` / ``neck`` /
    ``bbox_head`` sections (``yolov5s_dota.py``), each built as in JAX.
    ``ema`` and ``ema_decay`` are read by the runner; ``ch``, ``imgsz``,
    ``is_coco``, ``cls_pw``, ``obj_pw``, ``fl_gamma`` and ``pretrained``
    are accepted and read by nothing, as in JAX."""

    def __init__(self, backbone=None, neck=None, bbox_head=None,
                 nc: int = 80, ch: int = 3, imgsz=None, is_coco=False,
                 ema: bool = False, ema_decay: float = 0.9999,
                 boxlg: float = 0.05, clslg: float = 0.5, objlg: float = 1.0,
                 cls_pw: float = 1.0, obj_pw: float = 1.0,
                 fl_gamma: float = 0.0, anchor_t: float = 4.0,
                 depth_multiple: float = 0.33, width_multiple: float = 0.5,
                 pretrained=None):
        mult = dict(depth_multiple=depth_multiple,
                    width_multiple=width_multiple)
        bb = _build(backbone, BACKBONES, lambda: CSPDarknet(**mult))
        if isinstance(neck, dict):
            neck = dict(neck, in_channels=bb.out_channels)
        nk = _build(neck, NECKS, lambda: YOLOPAN(
            in_channels=bb.out_channels, **mult))
        if isinstance(bbox_head, dict):
            bbox_head = dict(bbox_head, in_channels=nk.out_channels)
        head = _build(bbox_head, HEADS, lambda: YOLOv5Head(
            num_classes=nc, box_w=boxlg, cls_w=clslg, obj_w=objlg,
            anchor_t=anchor_t, in_channels=nk.out_channels))
        super().__init__(backbone=bb, neck=nk, bbox_head=head)
        self.ema, self.ema_decay = ema, ema_decay


# the reference's variant names (the yolov5{s,m,l,x} configs): depth and
# width multiples of the yolov5 model yamls
YOLO_VARIANTS = {
    "YOLOv5S": (0.33, 0.50),
    "YOLOv5M": (0.67, 0.75),
    "YOLOv5L": (1.00, 1.00),
    "YOLOv5X": (1.33, 1.25),
}


def _register_variant(name, dm, wm):
    def ctor(**kw):
        kw.setdefault("depth_multiple", dm)
        kw.setdefault("width_multiple", wm)
        return YOLO(**kw)
    ctor.__name__ = name
    MODELS.register_module(name=name, module=ctor)


for _n, (_dm, _wm) in YOLO_VARIANTS.items():
    _register_variant(_n, _dm, _wm)
