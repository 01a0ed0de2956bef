"""Checkpoint-parity harness of the port (counterpart of
``tools/parity_check.py``): a reference (JDet) checkpoint -> the name
remap -> the layout conversion -> a shape audit against the port
module's ``state_dict`` -> the port's ``predict`` on a device ->
detections recorded, or diffed against recorded ones.

The reference trains with Jittor (or torch) and saves pickles of a flat
state dict (``{meta, model: {dotted.name: ndarray}}``). Here:

  1. the model is built from a config through the port's registry;
  2. the checkpoint is converted: JDet -> port NAME REMAP
     (``remap_reference_names``), OIHW / [out, in] layouts through
     ``utils/checkpoint_convert.py:torch_state_to_flax`` (with the
     NCHW-flatten permute of the RoI head's first shared FC,
     ``fc_spatial``) and ``utils/jax_weights.py:jax_to_state_dict``;
  3. every name and shape is AUDITED against the module's
     ``state_dict``: each missing, extra or misshapen entry is printed
     and the tool exits 2; nothing loads silently;
  4. eval-mode inference over a tile directory on the device asked for
     (the card unless ``--cpu``);
  5. ``--record`` writes the detections as a fixture, ``--ref-dets``
     diffs them against one (greedy poly-IoU matching per image, the IoU
     of ``ops/nms_poly.py``) and fails on drift.

``--selftest`` proves the loop without a reference checkpoint: the tiny
flagship's seeded weights are exported in the reference's style (JDet
names, torch layouts; ``export_reference_style``), detections recorded,
the pickle loaded into a model of other weights through steps 2-4, and
the detections must match exactly.

Usage:
  python -m rs_detection_tpu_torch.tools.parity_check --config CFG \\
      --ckpt ref.pkl --images tiles/ (--record dets.pkl |
      --ref-dets dets.pkl) [--score-thr 0.05] [--cpu]
  python -m rs_detection_tpu_torch.tools.parity_check --selftest
"""

from __future__ import annotations

import argparse
import os
import pickle
import re
import tempfile

import numpy as np
import torch

from ..ops.nms_poly import iou_poly_single

# ------------------------------------------------------------- remap

_RULES = [
    # jdet VAN: ModuleList blocks / LKA / conv-Mlp naming
    (re.compile(r"\bblock(\d+)\.(\d+)\."), r"block\1_\2."),
    (re.compile(r"\bspatial_gating_unit\."), "sgu."),
    (re.compile(r"\bmlp\.dwconv\.dwconv\."), "mlp.dwconv."),
    # jdet OrientedHead fc stack
    (re.compile(r"\bshared_fcs\.(\d+)\."), r"shared_fc\1."),
    # torch-style Sequential downsample in resnet
    (re.compile(r"\bdownsample\.0\."), "downsample_conv."),
    (re.compile(r"\bdownsample\.1\."), "downsample_bn."),
]

# the inverse, for the exporter: port names -> jdet names
_INVERSE = [
    (re.compile(r"\bblock(\d+)_(\d+)\."), r"block\1.\2."),
    (re.compile(r"\.sgu\."), ".spatial_gating_unit."),
    (re.compile(r"\bmlp\.dwconv\.(weight|bias)$"), r"mlp.dwconv.dwconv.\1"),
    (re.compile(r"\bshared_fc(\d+)\."), r"shared_fcs.\1."),
    (re.compile(r"\bdownsample_conv\."), "downsample.0."),
    (re.compile(r"\bdownsample_bn\."), "downsample.1."),
]


def remap_reference_names(state):
    """Reference (jittor/torch) dotted names -> the flax-form names the
    port's modules carry (a BatchNorm's leaves one level deeper, under
    ``BatchNorm_0``). Unknown names pass through untouched: the shape
    audit catches them loudly."""
    out = {}
    bn_prefixes = {k[:-len(".running_mean")] for k in state
                   if k.endswith(".running_mean")}
    for name, value in state.items():
        new = name
        for pat, rep in _RULES:
            new = pat.sub(rep, new)
        # every flax BatchNorm lives one level deep
        # (<name>/BatchNorm_0/...); insert that level for BN params
        for bp in bn_prefixes:
            bpn = bp
            for pat, rep in _RULES:
                bpn = pat.sub(rep, bpn)
            if new.startswith(bpn + "."):
                leaf = new[len(bpn) + 1:]
                if "." not in leaf:
                    new = f"{bpn}.BatchNorm_0.{leaf}"
                break
        out[new] = value
    return out


def _tree_shapes(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_tree_shapes(v, path))
        else:
            flat[path] = tuple(np.shape(v))
    return flat


def audit(converted, init_tree, collection):
    """Exact name+shape match or a loud, complete diff (nested trees or
    flat dicts)."""
    a = _tree_shapes(converted)
    b = _tree_shapes(init_tree)
    problems = []
    for k in sorted(set(a) | set(b)):
        if k not in b:
            problems.append(f"  EXTRA    {collection}/{k} {a[k]}")
        elif k not in a:
            problems.append(f"  MISSING  {collection}/{k} {b[k]}")
        elif a[k] != b[k]:
            problems.append(
                f"  SHAPE    {collection}/{k} ckpt{a[k]} != model{b[k]}")
    return problems


def reference_state(ckpt_path):
    """The flat state dict of a reference pickle (``{meta, model}``,
    ``{state_dict}`` or the dict itself), as numpy arrays."""
    from ..utils.jax_weights import load_jax_checkpoint

    data = load_jax_checkpoint(ckpt_path)
    state = data
    if isinstance(data, dict):
        for key in ("model", "state_dict"):
            if key in data and isinstance(data[key], dict):
                state = data[key]
                break
    if any(isinstance(v, dict) for v in state.values()):
        raise SystemExit(
            "checkpoint is a nested tree, expected a flat dotted-name "
            "state dict (jt.save / torch state_dict format)")
    return {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                else np.asarray(v)) for k, v in state.items()}


def convert_reference(state, fc_spatial=None):
    """A reference state dict -> {port state_dict name: array in torch
    layout}: the remap, ``torch_state_to_flax`` and
    ``jax_to_state_dict``."""
    from ..utils.checkpoint_convert import torch_state_to_flax
    from ..utils.jax_weights import jax_to_state_dict

    params, batch_stats = torch_state_to_flax(
        remap_reference_names(state), fc_spatial=fc_spatial)
    return jax_to_state_dict({"params": params, "batch_stats": batch_stats})


def module_state(model):
    """The module's loadable state by name (no BN counters, no loss
    states)."""
    from ..utils.jax_weights import loss_state_names

    skip = loss_state_names(model)
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked") and k not in skip}


def load_and_audit(model, ckpt_path, fc_spatial=None):
    """Checkpoint -> ``model`` (in place, returned), through the remap,
    the layout conversion and the audit; a mismatch prints every problem
    and exits 2."""
    from ..utils.checkpoint import load_model_arrays
    from ..utils.jax_weights import loss_state_names

    arrays = convert_reference(reference_state(ckpt_path), fc_spatial)
    problems = audit(arrays, module_state(model), "state_dict")
    if problems:
        print("checkpoint audit FAILED "
              f"({len(problems)} mismatches):")
        print("\n".join(problems[:200]))
        raise SystemExit(2)
    return load_model_arrays(model, arrays,
                             optional=loss_state_names(model))


def export_reference_style(model, fc_spatial=None):
    """The module's weights as a flat reference-style state dict (JDet
    names, torch layouts; the FCs named in ``fc_spatial`` over a (C, P,
    P)-flattened input) -- the inverse of the load, used to prove the
    loop."""
    fc_spatial = fc_spatial or {}
    flat = {}
    for name, v in module_state(model).items():
        v = v.detach().float().cpu().numpy()
        key = name[:-len(".weight")] if name.endswith(".weight") else None
        if key in fc_spatial and v.ndim == 2:
            c, ph, pw = fc_spatial[key]
            v = v.reshape(v.shape[0], ph, pw, c).transpose(0, 3, 1, 2) \
                .reshape(v.shape[0], -1)
        for pat, rep in _INVERSE:
            name = pat.sub(rep, name)
        flat[name] = np.ascontiguousarray(v)
    return flat


def head_fc_spatial(model_cfg):
    """The RoI head's first shared FC follows a spatial flatten: its
    (C, P, P) input from the config's head."""
    head = (model_cfg or {}).get("bbox_head") or {}
    c_in = head.get("in_channels", 256)
    p_out = (head.get("bbox_roi_extractor") or {}) \
        .get("roi_layer", {}).get("output_size", 7)
    return {"bbox_head.shared_fc0": (c_in, p_out, p_out)}


# -------------------------------------------------------- detections

@torch.no_grad()
def run_inference(model, image_arrays, score_thr=0.05, device=None):
    """Eval-mode ``predict`` of each uint8 HWC image on ``device`` (the
    model's when None) -> list of (polys, scores, labels)."""
    from ..flagship import normalize

    model.eval()
    if device is None:
        device = next(model.parameters()).device
    dets = []
    for arr in image_arrays:
        x = normalize(torch.from_numpy(np.array(arr, np.uint8))[None]
                      .to(device))
        out = model.predict(x)
        polys = out["polys"][0].float().cpu().numpy()
        scores = out["scores"][0].float().cpu().numpy()
        valid = (out["valid"][0].cpu().numpy().astype(bool)
                 if "valid" in out else np.ones(polys.shape[0], bool))
        labels = scores.argmax(-1)
        conf = scores.max(-1)
        keep = (conf >= score_thr) & valid
        dets.append((polys[keep], conf[keep], labels[keep]))
    return dets


def compare_dets(ref, got, iou_thr=0.7, score_tol=0.05,
                 count_tol=0.05):
    """Greedy per-image matching; returns (ok, report)."""
    lines = []
    ok = True
    for i, ((rp, rs, rl), (gp, gs, gl)) in enumerate(zip(ref, got)):
        nr, ng = len(rs), len(gs)
        if nr == 0 and ng == 0:
            continue
        denom = max(nr, 1)
        if abs(nr - ng) > count_tol * denom:   # count_tol=0 -> exact
            ok = False
            lines.append(f"img {i}: det count {ng} vs ref {nr}")
        matched = 0
        score_err = []
        used = np.zeros(ng, bool)
        for j in np.argsort(-rs):
            best, best_iou = -1, iou_thr
            for k in range(ng):
                if used[k] or gl[k] != rl[j]:
                    continue
                iou = iou_poly_single(rp[j], gp[k])
                if iou > best_iou:
                    best, best_iou = k, iou
            if best >= 0:
                used[best] = True
                matched += 1
                score_err.append(abs(float(rs[j]) - float(gs[best])))
        recall = matched / denom
        mae = float(np.mean(score_err)) if score_err else 0.0
        lines.append(f"img {i}: matched {matched}/{nr} "
                     f"(recall {recall:.3f}), score MAE {mae:.4f}")
        if recall < 1.0 - count_tol or mae > score_tol:
            ok = False
    return ok, "\n".join(lines)


# ------------------------------------------------------------ selftest

def selftest(device="cpu"):
    """Export the tiny flagship's seeded weights in the reference's
    style, reload them into a model of other weights through the remap,
    the conversion and the audit, and require identical detections."""
    from ..flagship import build_flagship

    print("parity_check selftest: tiny flagship round-trip")
    model = build_flagship(tiny=True, device=device,
                           generator=torch.Generator().manual_seed(3))
    img = 64
    rng = np.random.RandomState(0)
    images = [(rng.rand(img, img, 3) * 255).astype(np.uint8)
              for _ in range(2)]
    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "ref_style.pkl")
        with open(ckpt, "wb") as f:
            pickle.dump({"meta": {"source": "selftest"},
                         "model": export_reference_style(model)}, f)
        ref_dets = run_inference(model, images)
        other = build_flagship(tiny=True, device=device,
                               generator=torch.Generator().manual_seed(4))
        loaded = load_and_audit(other, ckpt)
        got_dets = run_inference(loaded, images)
    ok, report = compare_dets(ref_dets, got_dets, iou_thr=0.99,
                              score_tol=1e-5, count_tol=0.0)
    print(report)
    if not ok or not sum(len(d[1]) for d in ref_dets):
        raise SystemExit("selftest FAILED")
    print("selftest OK: audit exact, detections identical")
    return ref_dets, got_dets


# ---------------------------------------------------------------- main

def build_model(config_file):
    """The config's model through the port's registry, and its config."""
    from ..config import get_cfg, init_cfg
    from ..runner import runner as _runner  # noqa: F401  (registries)
    from ..utils.registry import MODELS, build_from_cfg

    init_cfg(config_file)
    cfg = get_cfg()
    return build_from_cfg(cfg.model, MODELS), cfg


def read_images(images_dir):
    """(file names, uint8 RGB arrays) of the tiles under ``images_dir``."""
    from PIL import Image

    paths = sorted(
        p for p in os.listdir(images_dir)
        if p.lower().endswith((".png", ".jpg", ".jpeg", ".tif")))
    images = []
    for p in paths:
        with Image.open(os.path.join(images_dir, p)) as im:
            images.append(np.asarray(im.convert("RGB"), np.uint8))
    return paths, images


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--config", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--images", default=None)
    ap.add_argument("--ref-dets", default=None)
    ap.add_argument("--record", default=None,
                    help="write current detections to this pickle")
    ap.add_argument("--score-thr", type=float, default=0.05)
    ap.add_argument("--iou-thr", type=float, default=0.7)
    ap.add_argument("--score-tol", type=float, default=0.05)
    ap.add_argument("--count-tol", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the host CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.selftest:
        # on the CPU: it must work on any box
        selftest("cpu")
        return None

    if not (args.config and args.ckpt and args.images):
        raise SystemExit("--config, --ckpt and --images are required "
                         "(or --selftest)")
    from ..flagship import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    model, cfg = build_model(args.config)
    paths, images = read_images(args.images)
    if not images:
        raise SystemExit(f"no images under {args.images}")
    load_and_audit(model, args.ckpt,
                   fc_spatial=head_fc_spatial(cfg.model))
    print("checkpoint audit OK: every name and shape matches")
    model.to(device)
    dets = run_inference(model, images, score_thr=args.score_thr,
                         device=device)

    if args.record:
        with open(args.record, "wb") as f:
            pickle.dump({"files": paths, "dets": dets}, f)
        print(f"recorded {sum(len(d[1]) for d in dets)} detections "
              f"over {len(paths)} images -> {args.record}")
        return dets

    if args.ref_dets:
        with open(args.ref_dets, "rb") as f:
            ref = pickle.load(f)["dets"]
        ok, report = compare_dets(ref, dets, iou_thr=args.iou_thr,
                                  score_tol=args.score_tol,
                                  count_tol=args.count_tol)
        print(report)
        if not ok:
            raise SystemExit("PARITY FAILED")
        print("PARITY OK")
    return dets


if __name__ == "__main__":
    main()
